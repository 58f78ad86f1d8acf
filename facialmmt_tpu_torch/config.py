"""Configuration tree of the PyTorch port.

The port's own typed dataclass tree: the same classes, fields and defaults as
the JAX package's config (and the reference's argparse flags, reference
main.py:12-105), minus the fields that only select a TPU kernel variant or a
JAX PRNG implementation.  Kernel dispatch in the port is by the tensor's
device and shape (ops/kernels/), not by a config field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class EncoderConfig:
    """Post-LN self-attention utterance encoder (reference modules/Transformer.py:196-227).

    One config is shared by the audio / vision / unimodal encoders; only the layer
    count and sequence length differ per modality.
    """

    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02


@dataclass(frozen=True)
class CrossModalConfig:
    """Pre-LN MulT-style crossmodal encoder (reference modules/CrossmodalTransformer.py:9-96)."""

    embed_dim: int = 768
    num_heads: int = 12
    layers: int = 2
    attn_dropout: float = 0.1
    gelu_dropout: float = 0.0
    res_dropout: float = 0.0
    embed_dropout: float = 0.0
    attn_mask: bool = False  # causal banded mask (off in the main model)


@dataclass(frozen=True)
class SwinConfig:
    """Swin-tiny backbone (reference modules/SwinTransformer/swin_conf.yaml:4-22)."""

    img_size: int = 224
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_heads: tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.3
    patch_norm: bool = True
    ape: bool = False
    # activation checkpointing of each block in the backward pass; 'auto'
    # resolves by the packed image count (resolve_remat).  Not wired into the
    # port's Swin yet: its block halves already save only their inputs.
    remat: "bool | str" = "auto"
    out_feature_dim: int = 512  # LN -> flatten -> Linear(49*768, 512) -> BatchNorm1d
                                # (reference Swin_Transformer.py:491-494)

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))

    @property
    def patches_resolution(self) -> tuple[int, int]:
        r = self.img_size // self.patch_size
        return (r, r)

    @staticmethod
    def from_yaml(path: str, backbone_type: str = "SwinTransformer"
                  ) -> "SwinConfig":
        """Load the reference's backbone config YAML (reference
        modules/SwinTransformer/backbone_def.py:8-53, swin_conf.yaml:4-22)."""
        import yaml

        with open(path) as f:
            conf = yaml.safe_load(f)[backbone_type]
        return SwinConfig(
            img_size=int(conf.get("img_size", 224)),
            patch_size=int(conf.get("patch_size", 4)),
            in_chans=int(conf.get("in_chans", 3)),
            embed_dim=int(conf.get("embed_dim", 96)),
            depths=tuple(conf.get("depths", (2, 2, 6, 2))),
            num_heads=tuple(conf.get("num_heads", (3, 6, 12, 24))),
            window_size=int(conf.get("window_size", 7)),
            mlp_ratio=float(conf.get("mlp_ratio", 4.0)),
            drop_rate=float(conf.get("drop_rate", 0.0)),
            drop_path_rate=float(conf.get("drop_path_rate", 0.3)))


@dataclass(frozen=True)
class TextEncoderConfig:
    """RoBERTa/BERT-style dialogue text encoder (reference src/models.py:72-77).

    Defaults are roberta-large / bert-large dims; the encoder is
    models/text_encoder.py, with parameter names of the HF state_dict.
    """

    model_type: str = "roberta"  # 'roberta' | 'bert'
    vocab_size: int = 50265      # roberta-large; bert-large-uncased = 30522
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 514  # roberta offset quirk; bert = 512
    type_vocab_size: int = 1            # bert = 2
    pad_token_id: int = 1               # roberta pad=1; bert pad=0
    layer_norm_eps: float = 1e-5        # roberta 1e-5; bert 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    # activation checkpointing of each layer; 'auto' resolves by the token
    # count (resolve_remat).  Not wired into the port's text tower yet.
    remat: "bool | str" = "auto"

    @staticmethod
    def roberta_large() -> "TextEncoderConfig":
        return TextEncoderConfig()

    @staticmethod
    def bert_large() -> "TextEncoderConfig":
        return TextEncoderConfig(
            model_type="bert", vocab_size=30522, max_position_embeddings=512,
            type_vocab_size=2, pad_token_id=0, layer_norm_eps=1e-12)

    @staticmethod
    def chinese_roberta_large() -> "TextEncoderConfig":
        """chinese-roberta-wwm-ext-large, a BERT-architecture model the
        appendix loads via BertModel for M3ED (reference
        (Appendix)CCAC2023/main.py:20)."""
        return TextEncoderConfig(
            model_type="bert", vocab_size=21128, max_position_embeddings=512,
            type_vocab_size=2, pad_token_id=0, layer_norm_eps=1e-12)

    @staticmethod
    def tiny(model_type: str = "roberta") -> "TextEncoderConfig":
        """Small config for tests / dry-runs."""
        return TextEncoderConfig(
            model_type=model_type, vocab_size=512, hidden_size=64, num_layers=2,
            num_heads=4, intermediate_size=128,
            max_position_embeddings=130 if model_type == "roberta" else 128,
            type_vocab_size=1 if model_type == "roberta" else 2,
            pad_token_id=1 if model_type == "roberta" else 0)


@dataclass(frozen=True)
class DataConfig:
    """Dataset paths + static shape hyperparameters.

    The reference derives max lens from the pickles at runtime (main.py:134-145) and
    hard-codes TEXT_MAX_UTT_LEN=38 (utils/dataset.py:24) and Max_seq_length=512
    (src/meld_bert_extraText.py:9).  Here they are explicit statics.
    """

    load_anno_csv_path: str = ""
    meld_text_path: str = ""
    data_load_path: str = "preprocess_data"
    # Aff-Wild2 auxiliary
    data_folder: str = ""
    anno_folder: str = ""
    data_list_train: str = ""
    # static shapes
    max_seq_length: int = 512          # dialogue token budget
    text_utt_max_len: int = 38         # per-utterance word span cap
    audio_utt_max_len: int = 157       # mean+3*sigma baked into the audio pkl shapes
    vision_utt_max_len: int = 32       # mean+3*sigma baked into the vision pkl shapes
    audio_feat_dim: int = 768          # wav2vec2.0 (reference README.md:118)
    vision_feat_dim: int = 512         # InceptionResnetV1 (reference README.md:116)
    swin_img_size: int = 224
    normalize_mean: tuple[float, float, float] = (0.5, 0.5, 0.5)
    normalize_std: tuple[float, float, float] = (0.5, 0.5, 0.5)


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer/schedule settings (reference train.py:305-349, main.py:46-61,87)."""

    num_epochs: int = 1
    aux_lr: float = 5e-5
    trg_lr: float = 7e-6
    weight_decay: float = 0.01     # applied to ALL params incl. norms (reference train.py:307)
    warm_up: float = 0.1           # fraction of total steps
    aux_batch_size: int = 150
    trg_batch_size: int = 1
    aux_accumulation_steps: int = 1
    trg_accumulation_steps: int = 4
    clip: float = 0.8
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-6         # transformers.AdamW default
    patience: int = 0              # early stopping on val loss (appendix
                                   # (Appendix)CCAC2023/train.py:114-152); 0 = off


@dataclass(frozen=True)
class ParallelConfig:
    """Multi-device layout: data-parallel and tensor-parallel ways.  The port
    runs on one device so far; the fields are kept for the multi-device slice."""

    dp: int = 1         # data-parallel ways; -1 = all devices (CLI default)
    tp: int = 1         # tensor-parallel ways (the text tower)
    data_axis: str = "data"
    model_axis: str = "model"
    zero1: bool = True  # shard optimizer moments over the data-parallel ranks


@dataclass(frozen=True)
class RuntimeConfig:
    seed: int = 1111
    compute_dtype: str = "bfloat16"     # reference uses fp16 AMP for T+A+V (main.py:154)
    param_dtype: str = "float32"
    deterministic_gumbel: bool = False  # reference SAMPLES gumbel noise at eval
                                        # (src/models.py:31-32); True => softmax(logits/tau)
    debug_nans: bool = False
    aux_log_interval: int = 1000
    trg_log_interval: int = 1600
    save_model_path: str = "saved_model"
    metrics_path: str = "metrics.jsonl"
    profile_dir: str = ""
    eval_face_chunk: int = 0            # >0: run the eval Swin over the packed
                                        # faces in tiles of this size, so only
                                        # one tile's activations are live; 0 =
                                        # all faces in one pass


@dataclass(frozen=True)
class FacialMMTConfig:
    """Top-level config, mirroring the reference flag surface."""

    choice_modality: str = "T+A+V"     # 'T+A+V' | 'V' | (appendix: 'T+A' | 'T+V')
    plm_name: str = "roberta-large"    # 'roberta-large' | 'bert-large'
    do_eval: bool = True
    num_labels: int = 7
    hidden_size: int = 768
    tau: float = 1.0                             # gumbel temperature (main.py:41)
    facial_emo_impor_threshold: float = 0.2      # frame filter threshold (main.py:42-43)
    audio_utt_transformer_num: int = 5
    vision_utt_transformer_num: int = 2
    modality_fuse: str = "crossmodal"  # 'crossmodal' | 'concat' (appendix main.py:43)
    granularity: str = "utt"           # 'utt' | 'dia'       (appendix --uttORdia)
    swin_from_target: bool = False     # True = joint training: target-task
                                       # grads DO update Swin.  False = the
                                       # reference's two-optimizer coupling
                                       # (grads into Swin computed then
                                       # discarded, reference train.py:305-340)

    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    crossmodal_ta: CrossModalConfig = field(default_factory=CrossModalConfig)
    crossmodal_ta_v: CrossModalConfig = field(default_factory=CrossModalConfig)
    swin: SwinConfig = field(default_factory=SwinConfig)
    text: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    # eval-mode checkpoint paths (reference main.py:97-103)
    load_unimodal_path: str = "unimodal_model_V.pt"
    load_multimodal_path: str = "multimodal_model_T+A+V_RoBERTa.pt"
    load_swin_path: str = "best_swin_RoBERTa.pt"
    pretrained_backbone_path: str = "pretrained_model/Swin_tiny_Ms-Celeb-1M.pt"
    pretrained_text_model_path: str = ""

    @property
    def vision_emb_dim(self) -> int:
        """InceptionResnet 512 + 7-dim FER distribution concat (reference src/models.py:67)."""
        return self.data.vision_feat_dim + self.num_labels

    def replace(self, **kw: Any) -> "FacialMMTConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def tiny() -> "FacialMMTConfig":
        """Small end-to-end config for unit tests and dry-runs."""
        enc = EncoderConfig(hidden_size=64, num_attention_heads=4, intermediate_size=128)
        cm = CrossModalConfig(embed_dim=64, num_heads=4, layers=2)
        swin = SwinConfig(img_size=32, patch_size=4, embed_dim=8,
                          depths=(1, 1), num_heads=(2, 4), window_size=4,
                          drop_path_rate=0.0, out_feature_dim=16)
        data = DataConfig(audio_utt_max_len=12, vision_utt_max_len=6,
                          audio_feat_dim=24, vision_feat_dim=16,
                          max_seq_length=64, text_utt_max_len=10, swin_img_size=32)
        return FacialMMTConfig(
            hidden_size=64, encoder=enc, crossmodal_ta=cm, crossmodal_ta_v=cm,
            swin=swin, text=TextEncoderConfig.tiny(), data=data,
            audio_utt_transformer_num=2, vision_utt_transformer_num=1)


def resolve_remat(remat, units: int, threshold: int) -> bool:
    """'auto' activation-checkpointing policy, decided from the batch shape:
    recompute in the backward only when the activation scale (`units`: packed
    images for Swin, tokens for the text tower) exceeds `threshold`."""
    if remat == "auto":
        return units > threshold
    return bool(remat)


def resolve_text_config(cfg: FacialMMTConfig) -> TextEncoderConfig:
    """Pick the text tower config from --plm_name the way the reference keys off the
    checkpoint directory name (reference src/models.py:49-52)."""
    if cfg.text.hidden_size != 1024:
        tc = cfg.text  # explicitly overridden (tests / tiny configs)
    elif cfg.plm_name == "roberta-large":
        tc = TextEncoderConfig.roberta_large()
    elif cfg.plm_name == "bert-large":
        tc = TextEncoderConfig.bert_large()
    elif cfg.plm_name == "chinese-roberta-large":
        tc = TextEncoderConfig.chinese_roberta_large()
    else:
        tc = cfg.text
    if tc.remat != cfg.text.remat:
        # remat is a memory/speed knob, not part of the PLM identity: honor
        # the configured value even when the PLM preset supplies the rest
        tc = dataclasses.replace(tc, remat=cfg.text.remat)
    return tc
