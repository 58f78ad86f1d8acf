"""Command line of the port (counterpart of facialmmt_tpu/main.py), with the
JAX package's flag surface (the reference's flags, reference main.py:12-105)
plus `--device`.

    python -m facialmmt_tpu_torch.main --choice_modality T+A+V --doEval 1 \
        --data_load_path preprocess_data --pretrained_model_dir pretrained_model \
        --load_multimodal_path multimodal_model_T+A+V_RoBERTa.pt \
        --load_swin_path best_swin_RoBERTa.pt
    python -m facialmmt_tpu_torch.main --choice_modality V --doEval 1 \
        --data_load_path preprocess_data --load_unimodal_path unimodal_model_V.pt
    python -m facialmmt_tpu_torch.main --choice_modality T+A+V --doEval 0 \
        --data_folder ... --anno_folder ... --pretrained_backbone_path ... \
        --pretrainedtextmodel_path pretrained_model/roberta-large    (train)
    python -m facialmmt_tpu_torch.main --choice_modality T --doEval 0 \
        --meld_text_path m3ed --pretrainedtextmodel_path ...   (appendix)
    python -m facialmmt_tpu_torch.main --choice_modality T+A+V \
        --m3ed_project_path m3ed --uttORdia dia --modalityFuse concat \
        --doEval 1 --submission_template nustm_submission_empty.csv

Runs on the card (`--device cuda`, the default; without one it raises) unless
`--device cpu` is given.  Several ranks: `torchrun --nproc_per_node N -m
facialmmt_tpu_torch.main ... --dp D --tp T` (parallel/mesh.py; --dp -1 takes
every rank / T; rank 0 alone prints and writes files).  `--swin_remat` /
`--text_remat` 1 checkpoint every Swin block / text layer, 'auto' above 512
images / 4096 tokens.  Ported: MELD T+A+V, T+A, T+V (the FER pipeline)
and V, evaluation from the reference's released files and training from the
pretrained Swin backbone and a local HF text tower; the appendix: T on the
M3ED text, M3ED T+A / T+V / T+A+V at the utterance or dialogue level,
MELD's dialogue level, crossmodal or concat fusion, macro-F1, the submission
CSV and the 'pred true' dump.  `--profile_dir D` writes a torch.profiler
trace of train steps 3-7 into D (utils/observability.py::StepProfiler);
`--debug_nans 1` raises FloatingPointError at the first module or backward
Function that makes a NaN (enable_nan_debugging).  Any JAX command line
parses; an explicit --submission_template that does not exist raises
FileNotFoundError before any data loads, and the three flags that select a
JAX implementation accept only the values that select nothing here
(config_from_args).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

# the template's name in the reference's project
# ((Appendix)CCAC2023/nustm_submission_empty.csv)
DEFAULT_TEMPLATE = "nustm_submission_empty.csv"


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="FacialMMT on PyTorch and CUDA: facial-expression-aware "
                    "multimodal multi-task ERC")
    # dataset paths (reference main.py:16-32)
    p.add_argument("--load_anno_csv_path", type=str, default="")
    p.add_argument("--meld_text_path", type=str, default="")
    p.add_argument("--num_labels", type=int, default=7)
    p.add_argument("--data_load_path", type=str, default="preprocess_data")
    p.add_argument("--save_Model_path", type=str, default="saved_model")
    p.add_argument("--plm_name", type=str, default="roberta-large",
                   choices=["roberta-large", "bert-large",
                            "chinese-roberta-large"])
    p.add_argument("--choice_modality", type=str, default="T+A+V",
                   choices=["T+A+V", "V", "T+A", "T+V", "T"])
    # aff-wild2 (reference main.py:27-32)
    p.add_argument("--data_folder", type=str, default="")
    p.add_argument("--anno_folder", type=str, default="")
    p.add_argument("--data_list_train", type=str, default="")
    # swin (reference main.py:35-43)
    p.add_argument("--pretrained_backbone_path", type=str, default="")
    p.add_argument("--tau", type=float, default=1.0)
    p.add_argument("--FacialEmoImpor_threshold", type=float, default=0.2)
    # tuning (reference main.py:46-61)
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--aux_lr", type=float, default=5e-5)
    p.add_argument("--trg_lr", type=float, default=7e-6)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--warm_up", type=float, default=0.1)
    p.add_argument("--aux_batch_size", type=int, default=150)
    p.add_argument("--trg_batch_size", type=int, default=1)
    p.add_argument("--aux_accumulation_steps", type=int, default=1)
    p.add_argument("--trg_accumulation_steps", type=int, default=4)
    # fusion (reference main.py:64-70)
    p.add_argument("--crossmodal_layers_TA", type=int, default=2)
    p.add_argument("--crossmodal_num_heads_TA", type=int, default=12)
    p.add_argument("--crossmodal_attn_dropout_TA", type=float, default=0.1)
    p.add_argument("--crossmodal_layers_TA_V", type=int, default=2)
    p.add_argument("--crossmodal_num_heads_TA_V", type=int, default=12)
    p.add_argument("--crossmodal_attn_dropout_TA_V", type=float, default=0.1)
    # encoders (reference main.py:74-84)
    p.add_argument("--audio_utt_Transformernum", type=int, default=5)
    p.add_argument("--vision_utt_Transformernum", type=int, default=2)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_attention_heads", type=int, default=12)
    p.add_argument("--intermediate_size", type=int, default=3072)
    p.add_argument("--hidden_dropout_prob", type=float, default=0.1)
    p.add_argument("--attention_probs_dropout_prob", type=float, default=0.1)
    p.add_argument("--layer_norm_eps", type=float, default=1e-12)
    # misc (reference main.py:87-103)
    p.add_argument("--clip", type=float, default=0.8)
    p.add_argument("--aux_log_interval", type=int, default=1000)
    p.add_argument("--trg_log_interval", type=int, default=1600)
    p.add_argument("--seed", type=int, default=1111)
    p.add_argument("--doEval", type=int, default=1)
    p.add_argument("--load_unimodal_path", type=str,
                   default="unimodal_model_V.pt")
    p.add_argument("--load_multimodal_path", type=str,
                   default="multimodal_model_T+A+V_RoBERTa.pt")
    p.add_argument("--load_swin_path", type=str, default="best_swin_RoBERTa.pt")
    p.add_argument("--pretrained_model_dir", type=str,
                   default="pretrained_model")
    # appendix (CCAC2023 / M3ED)
    p.add_argument("--modalityFuse", type=str, default="crossmodal",
                   choices=["crossmodal", "concat"])
    p.add_argument("--uttORdia", type=str, default="utt",
                   choices=["utt", "dia"])
    p.add_argument("--patience", type=int, default=0,
                   help="early stopping on val loss; 0 disables")
    p.add_argument("--load_best_model_path", type=str, default="",
                   help="directory of the best file for the appendix's "
                        "--doEval 1; defaults to --save_Model_path")
    p.add_argument("--submission_template", type=str,
                   default=DEFAULT_TEMPLATE,
                   help="competition CSV template; the default name is "
                        "skipped when absent, any other path must exist")
    p.add_argument("--submission_out", type=str, default="",
                   help="filled submission CSV; defaults to "
                        "<save_Model_path>/nustm_submission.csv")
    p.add_argument("--pred_dump_path", type=str, default="",
                   help="'pred true' dump file of the appendix's eval")
    p.add_argument("--pretrainedtextmodel_path", type=str, default="",
                   help="local HF directory of the text tower's pretrained "
                        "weights (and tokenizer, to build a missing text "
                        "cache)")
    p.add_argument("--m3ed_project_path", type=str, default="",
                   help="M3ED directory ({split}_utt_text_noEmo.json, "
                        "m3ed_{split}_{audio,vision}_{utt,dia}.pkl and the "
                        "profile JSONs): the multimodal data load M3ED-style "
                        "(precomputed vision features, no faces or FER "
                        "branch)")
    # extensions of the JAX package
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="bfloat16 = bf16 autocast on the card (fp32 on the "
                        "CPU whatever the flag)")
    p.add_argument("--max_seq_length", type=int, default=512,
                   help="M3ED dialogue token budget; MELD dialogues are "
                        "512 tokens whatever it says, as in the reference")
    p.add_argument("--text_preset", type=str, default="auto",
                   choices=["auto", "tiny"])
    p.add_argument("--swin_from_target", type=int, default=0)
    p.add_argument("--swin_config_path", type=str, default="")
    p.add_argument("--swin_attention_impl", type=str, default="auto",
                   choices=["xla", "pallas", "pair", "auto"],
                   help="the Swin attention half: 'auto' = the fused block "
                        "kernel, 'pallas'/'pair' = the window-attention "
                        "kernels, 'xla' = plain (config.py::SwinConfig)")
    p.add_argument("--swin_mlp_impl", type=str, default="auto",
                   choices=["xla", "pallas", "auto"])
    p.add_argument("--swin_merge_impl", type=str, default="auto",
                   choices=["raster", "window", "auto"])
    p.add_argument("--fused_text_attention", type=str, default="",
                   choices=["", "auto", "on", "off"],
                   help="only '' or 'auto': the tensor's device picks the "
                        "kernel")
    p.add_argument("--fused_fusion_attention", type=str, default="",
                   choices=["", "auto", "on", "off"],
                   help="only '' or 'auto': the tensor's device picks the "
                        "kernel")
    p.add_argument("--eval_face_chunk", type=int, default=0)
    p.add_argument("--deterministic_gumbel", type=int, default=0)
    p.add_argument("--debug_nans", type=int, default=0)
    p.add_argument("--profile_dir", type=str, default="",
                   help="non-empty: write a torch.profiler trace of train "
                        "steps 3-7 (Chrome trace, *.pt.trace.json) here")
    p.add_argument("--prng_impl", type=str, default="auto",
                   choices=["auto", "rbg", "threefry2x32"],
                   help="only 'auto': the port draws from a torch.Generator")
    p.add_argument("--swin_remat", type=str, default="auto",
                   choices=["auto", "0", "1"])
    p.add_argument("--text_remat", type=str, default="auto",
                   choices=["auto", "0", "1"])
    p.add_argument("--resume", type=int, default=0,
                   help="resume from the latest resume checkpoint")
    p.add_argument("--dp", type=int, default=-1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--metrics_path", type=str, default="metrics.jsonl")
    # the port's own
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def check_ported(args) -> None:
    """Raise for a command line the port cannot run: ValueError for a
    value of a JAX implementation switch, which has no counterpart here.
    --dp / --tp asking for more than one rank need torchrun's environment
    (NotImplementedError naming torchrun without it), and --tp must divide
    its WORLD_SIZE (ValueError)."""
    world = os.environ.get("WORLD_SIZE")
    if (args.dp not in (-1, 1) or args.tp != 1) and world is None:
        raise NotImplementedError(
            f"--dp {args.dp} --tp {args.tp}: a multi-device run is launched "
            f"with torchrun (torchrun --nproc_per_node N -m "
            f"facialmmt_tpu_torch.main ...), which sets WORLD_SIZE")
    if world is not None and (args.tp < 1 or int(world) % args.tp):
        raise ValueError(f"--tp {args.tp} does not divide the {world} ranks "
                         f"(WORLD_SIZE)")
    for flag in ("fused_text_attention", "fused_fusion_attention"):
        if getattr(args, flag) not in ("", "auto"):
            raise ValueError(
                f"--{flag} {getattr(args, flag)}: the port has no switch for "
                f"the attention kernel; the tensor's device decides (a CUDA "
                f"tensor takes the kernel, a CPU tensor the plain version, "
                f"config.py); pass '' or 'auto'")
    if args.prng_impl != "auto":
        raise ValueError(
            f"--prng_impl {args.prng_impl}: the port draws its random "
            f"numbers from a torch.Generator seeded by --seed; pass 'auto'")


def config_from_args(args) -> "FacialMMTConfig":
    from facialmmt_tpu_torch.config import (CrossModalConfig, DataConfig,
                                            EncoderConfig, FacialMMTConfig,
                                            OptimConfig, ParallelConfig,
                                            RuntimeConfig, SwinConfig,
                                            TextEncoderConfig)

    check_ported(args)
    enc = EncoderConfig(
        hidden_size=args.hidden_size,
        num_attention_heads=args.num_attention_heads,
        intermediate_size=args.intermediate_size,
        hidden_dropout_prob=args.hidden_dropout_prob,
        attention_probs_dropout_prob=args.attention_probs_dropout_prob,
        layer_norm_eps=args.layer_norm_eps)
    cm_ta = CrossModalConfig(embed_dim=args.hidden_size,
                             num_heads=args.crossmodal_num_heads_TA,
                             layers=args.crossmodal_layers_TA,
                             attn_dropout=args.crossmodal_attn_dropout_TA)
    cm_tav = CrossModalConfig(embed_dim=args.hidden_size,
                              num_heads=args.crossmodal_num_heads_TA_V,
                              layers=args.crossmodal_layers_TA_V,
                              attn_dropout=args.crossmodal_attn_dropout_TA_V)
    data = DataConfig(load_anno_csv_path=args.load_anno_csv_path,
                      meld_text_path=args.meld_text_path,
                      data_load_path=args.data_load_path,
                      data_folder=args.data_folder,
                      anno_folder=args.anno_folder,
                      data_list_train=args.data_list_train,
                      max_seq_length=args.max_seq_length)
    optim = OptimConfig(num_epochs=args.num_epochs, aux_lr=args.aux_lr,
                        trg_lr=args.trg_lr, weight_decay=args.weight_decay,
                        warm_up=args.warm_up,
                        aux_batch_size=args.aux_batch_size,
                        trg_batch_size=args.trg_batch_size,
                        aux_accumulation_steps=args.aux_accumulation_steps,
                        trg_accumulation_steps=args.trg_accumulation_steps,
                        clip=args.clip, patience=args.patience)
    runtime = RuntimeConfig(seed=args.seed, compute_dtype=args.compute_dtype,
                            profile_dir=args.profile_dir,
                            eval_face_chunk=args.eval_face_chunk,
                            deterministic_gumbel=bool(
                                args.deterministic_gumbel),
                            aux_log_interval=args.aux_log_interval,
                            trg_log_interval=args.trg_log_interval,
                            save_model_path=args.save_Model_path,
                            metrics_path=args.metrics_path)
    kw = {}
    if args.text_preset == "tiny":
        kw["text"] = TextEncoderConfig.tiny(
            "roberta" if args.plm_name == "roberta-large" else "bert")
    swin = (SwinConfig.from_yaml(args.swin_config_path)
            if args.swin_config_path else SwinConfig())
    remat_of = lambda s: s if s == "auto" else bool(int(s))  # noqa: E731
    kw["swin"] = dataclasses.replace(
        swin, attention_impl=args.swin_attention_impl,
        mlp_impl=args.swin_mlp_impl, merge_impl=args.swin_merge_impl,
        remat=remat_of(args.swin_remat))
    if args.text_remat != "auto":
        kw["text"] = dataclasses.replace(kw.get("text", TextEncoderConfig()),
                                         remat=remat_of(args.text_remat))
    return FacialMMTConfig(
        choice_modality=args.choice_modality, plm_name=args.plm_name,
        do_eval=bool(args.doEval), num_labels=args.num_labels,
        hidden_size=args.hidden_size, tau=args.tau,
        facial_emo_impor_threshold=args.FacialEmoImpor_threshold,
        audio_utt_transformer_num=args.audio_utt_Transformernum,
        vision_utt_transformer_num=args.vision_utt_Transformernum,
        modality_fuse=args.modalityFuse, granularity=args.uttORdia,
        swin_from_target=bool(args.swin_from_target),
        encoder=enc, crossmodal_ta=cm_ta, crossmodal_ta_v=cm_tav,
        data=data, optim=optim, runtime=runtime,
        parallel=ParallelConfig(dp=args.dp, tp=args.tp),
        load_unimodal_path=args.load_unimodal_path,
        load_multimodal_path=args.load_multimodal_path,
        load_swin_path=args.load_swin_path,
        pretrained_backbone_path=args.pretrained_backbone_path,
        pretrained_text_model_path=args.pretrainedtextmodel_path, **kw)


def resolve_pretrained_text_dir(cfg, pretrained_model_dir: str):
    """Training starts the text tower from pretrained PLM weights; the
    reference resolves <project>/pretrained_model/<plm_name> (reference
    main.py:118).  The same default here when --pretrainedtextmodel_path is
    empty; if that directory is absent too, this warns and the trainer keeps
    a random tower."""
    if (not cfg.do_eval and cfg.choice_modality != "V"
            and not cfg.pretrained_text_model_path):
        default_plm_dir = os.path.join(pretrained_model_dir, cfg.plm_name)
        if os.path.isdir(default_plm_dir):
            return cfg.replace(pretrained_text_model_path=default_plm_dir)
        print("WARNING: no --pretrainedtextmodel_path — the text tower "
              "is RANDOMLY initialized.  The reference always trains "
              "from pretrained PLM weights (src/models.py:72-77); "
              "point --pretrainedtextmodel_path (or "
              "<pretrained_model_dir>/<plm_name>) at a local HF dir "
              "for reference-equivalent training.")
    return cfg


def _adapt_static_shapes(cfg, train_ds):
    """The static feature shapes from the data, as the reference derives them
    at main.py:134-145, once."""
    data = cfg.data
    kw = dict(audio_utt_max_len=data.audio_utt_max_len,
              vision_utt_max_len=data.vision_utt_max_len,
              audio_feat_dim=data.audio_feat_dim,
              vision_feat_dim=data.vision_feat_dim)
    if hasattr(train_ds, "audio_max_utt_len"):
        kw["audio_utt_max_len"] = train_ds.audio_max_utt_len
        kw["audio_feat_dim"] = train_ds.audio_feat_dim
    if hasattr(train_ds, "vision_max_utt_len"):
        kw["vision_utt_max_len"] = train_ds.vision_max_utt_len
        kw["vision_feat_dim"] = train_ds.vision_feat_dim
    elif hasattr(train_ds, "max_utt_len"):
        kw["vision_utt_max_len"] = train_ds.max_utt_len
        kw["vision_feat_dim"] = train_ds.feat_dim
    return cfg.replace(data=dataclasses.replace(data, **kw))


def resolve_submission_template(path: str) -> str:
    """The submission template to fill, checked before any data loads: the
    default name, when it is absent, is skipped (''; the appendix's eval
    then notes that it writes no CSV), any other path that does not exist
    raises FileNotFoundError.  (The JAX package raises for a mistyped
    template only in the final eval, after training.)"""
    if path and not os.path.exists(path):
        if path != DEFAULT_TEMPLATE:
            raise FileNotFoundError(f"--submission_template not found: {path}")
        return ""
    return path


def text_arrays(cfg, split: str):
    """The split's tokenized MELD dialogues from the npz cache
    <data_load_path>/<modality>/text_{split}_{plm_name}.npz; a missing cache
    is built with the HF tokenizer (the only use of `transformers`) from
    {split}_sent_emo.csv and {split}_text.json and written.  The dialogues are
    512 tokens whatever --max_seq_length says, as in the reference
    (src/meld_bert_extraText.py:9) and the JAX CLI, so a cache either CLI
    wrote holds the same arrays."""
    from facialmmt_tpu_torch.data.meld import MeldTextArrays

    cache = os.path.join(cfg.data.data_load_path, cfg.choice_modality,
                         f"text_{split}_{cfg.plm_name}.npz")
    if os.path.exists(cache):
        with np.load(cache) as z:
            return MeldTextArrays(z["ids"], z["mask"], z["sep"])
    from transformers import AutoTokenizer

    from facialmmt_tpu_torch.data.text_prep import MeldTextPreprocessor

    tok = AutoTokenizer.from_pretrained(
        cfg.pretrained_text_model_path or cfg.plm_name)
    prep = MeldTextPreprocessor(tok, cfg.plm_name == "roberta-large")
    feats = prep.preprocess_split(
        os.path.join(cfg.data.load_anno_csv_path, f"{split}_sent_emo.csv"),
        os.path.join(cfg.data.meld_text_path, f"{split}_text.json"))
    ids, mask, sep = MeldTextPreprocessor.to_arrays(feats)
    np.savez(cache, ids=ids, mask=mask, sep=sep)
    return MeldTextArrays(ids, mask, sep)


def m3ed_text_arrays(cfg, text_dir: str, split: str):
    """(ids, mask, sep, labels) of the split's M3ED dialogues at
    --max_seq_length tokens, from the npz cache
    <data_load_path>/T/text_{split}_{plm_name}_m3ed.npz; a missing cache is
    built from <text_dir>/{split}_utt_text_noEmo.json with the HF tokenizer
    (reference (Appendix)CCAC2023/src/data_bert_extraText.py) and written."""
    cache = os.path.join(cfg.data.data_load_path, "T",
                         f"text_{split}_{cfg.plm_name}_m3ed.npz")
    if os.path.exists(cache):
        with np.load(cache) as z:
            return z["ids"], z["mask"], z["sep"], z["labels"]
    from transformers import AutoTokenizer

    from facialmmt_tpu_torch.data.text_prep import M3edTextPreprocessor

    tok = AutoTokenizer.from_pretrained(
        cfg.pretrained_text_model_path or cfg.plm_name)
    prep = M3edTextPreprocessor(tok, cfg.data.max_seq_length)
    ids, mask, sep, labels = M3edTextPreprocessor.to_arrays(
        prep.preprocess_split(
            os.path.join(text_dir, f"{split}_utt_text_noEmo.json")))
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    np.savez(cache, ids=ids, mask=mask, sep=sep, labels=labels)
    return ids, mask, sep, labels


def run(argv=None) -> float:
    """Parse `argv` (sys.argv when None), evaluate or train, return the test
    F1 (weighted for MELD utterances, macro for the appendix's trainers)."""
    args = build_argparser().parse_args(argv)
    cfg = config_from_args(args)          # raises for what is not ported
    args.submission_template = resolve_submission_template(
        args.submission_template)
    cfg = resolve_pretrained_text_dir(cfg, args.pretrained_model_dir)

    from facialmmt_tpu_torch.ops.kernels import resolve_device
    from facialmmt_tpu_torch.utils.observability import (MetricWriter,
                                                         enable_nan_debugging)

    device = resolve_device(args.device)   # raises without a card
    if args.debug_nans:
        enable_nan_debugging()   # for the life of the process
    stdout = sys.stdout
    if int(os.environ.get("RANK", "0")) != 0:
        sys.stdout = open(os.devnull, "w")  # rank 0 alone prints
    if not cfg.do_eval:
        # SIGTERM -> resume checkpoint -> Preempted (utils/preemption.py);
        # --resume 1 continues the interrupted epoch
        from facialmmt_tpu_torch.utils.preemption import \
            install_preemption_guard

        install_preemption_guard()
    writer = MetricWriter(cfg.runtime.metrics_path)
    try:
        print("&" * 50)
        if cfg.choice_modality == "V":
            return _run_unimodal(args, cfg, device, writer)
        if cfg.choice_modality == "T" or args.m3ed_project_path:
            return _run_m3ed(args, cfg, device, writer)
        return _run_multimodal(args, cfg, device, writer)
    finally:
        writer.close()
        if sys.stdout is not stdout:
            sys.stdout.close()
            sys.stdout = stdout


def _appendix_eval_kwargs(args):
    return dict(ckpt_dir=args.load_best_model_path or None,
                submission_template=args.submission_template,
                submission_out=args.submission_out,
                pred_dump_path=args.pred_dump_path)


def _run_unimodal(args, cfg, device, writer) -> float:
    from facialmmt_tpu_torch.data.meld import MeldVisionDataset
    from facialmmt_tpu_torch.train.trainer import Trainer

    test_ds = MeldVisionDataset(cfg.data.data_load_path, "test")
    cfg = _adapt_static_shapes(cfg, test_ds)
    trainer = Trainer(cfg, device, writer)
    if cfg.do_eval:
        print("Evaluating on the test set directly...")
        from facialmmt_tpu_torch.checkpoint.torch_load import \
            load_torch_state_dict

        sd = load_torch_state_dict(os.path.join(args.pretrained_model_dir,
                                                cfg.load_unimodal_path))
        return trainer.eval_unimodal_only(sd, test_ds)
    print("Training from scratch...")
    return trainer.run_unimodal(
        MeldVisionDataset(cfg.data.data_load_path, "train"),
        MeldVisionDataset(cfg.data.data_load_path, "val"), test_ds,
        resume=bool(args.resume))


def _run_m3ed(args, cfg, device, writer) -> float:
    """The appendix's M3ED paths: choice_modality T (text only, reference
    (Appendix)CCAC2023/utils/dataset.py:112-147) and, with
    --m3ed_project_path, T+A / T+V / T+A+V on precomputed features at the
    utterance or, with --uttORdia dia, the dialogue level (:165-302)."""
    from facialmmt_tpu_torch.data.m3ed import (M3edDialogueDataset,
                                               M3edMultimodalDataset,
                                               M3edTextDataset)
    from facialmmt_tpu_torch.train.trainer import (DialogueTrainer,
                                                   TextTrainer)

    text_dir = args.m3ed_project_path or cfg.data.meld_text_path
    resume = bool(args.resume)
    if cfg.choice_modality == "T":
        def build(split):
            return M3edTextDataset(*m3ed_text_arrays(cfg, text_dir, split))

        trainer = TextTrainer(cfg, device, writer)
        if cfg.do_eval:
            return trainer.eval_text_only(build("test"),
                                          **_appendix_eval_kwargs(args))
        return trainer.run_text(build("train"), build("val"), build("test"),
                                resume=resume)

    dia = cfg.granularity == "dia"
    ds_cls = M3edDialogueDataset if dia else M3edMultimodalDataset

    def build(split):
        ids, mask, sep, _ = m3ed_text_arrays(cfg, text_dir, split)
        return ds_cls(args.m3ed_project_path, split, ids, mask, sep)

    test_ds = build("test")
    cfg = _adapt_static_shapes(cfg, test_ds)
    if dia:
        trainer = DialogueTrainer(cfg, device, writer)
        if cfg.do_eval:
            return trainer.eval_dialogue_only(test_ds,
                                              **_appendix_eval_kwargs(args))
        return trainer.run_dialogue(build("train"), build("val"), test_ds,
                                    resume=resume)
    trainer = TextTrainer(cfg, device, writer)
    if cfg.do_eval:
        return trainer.eval_text_only(test_ds, **_appendix_eval_kwargs(args))
    return trainer.run_text(build("train"), build("val"), test_ds,
                            resume=resume)


def _run_multimodal(args, cfg, device, writer) -> float:
    """MELD T+A+V, T+A and T+V through the FER pipeline, or with --uttORdia
    dia the dialogue-level model on the same files (vision = the pickle's
    raw features)."""
    from facialmmt_tpu_torch.data.meld import MeldMultimodalDataset
    from facialmmt_tpu_torch.train.trainer import Trainer

    def build_split(split):
        return MeldMultimodalDataset(cfg.data.data_load_path, split,
                                     text_arrays(cfg, split),
                                     cfg.choice_modality)

    test_ds = build_split("test")
    cfg = _adapt_static_shapes(cfg, test_ds)
    if cfg.granularity == "dia":
        from facialmmt_tpu_torch.data.meld import MeldDialogueDataset
        from facialmmt_tpu_torch.train.trainer import DialogueTrainer

        trainer = DialogueTrainer(cfg, device, writer)
        dia_test = MeldDialogueDataset(test_ds)
        if cfg.do_eval:
            return trainer.eval_dialogue_only(dia_test,
                                              **_appendix_eval_kwargs(args))
        return trainer.run_dialogue(
            MeldDialogueDataset(build_split("train")),
            MeldDialogueDataset(build_split("val")), dia_test,
            resume=bool(args.resume))

    trainer = Trainer(cfg, device, writer)
    if cfg.do_eval:
        print("Evaluating on the test set directly...")
        from facialmmt_tpu_torch.checkpoint.torch_load import \
            released_state_dict

        sd = released_state_dict(
            os.path.join(args.pretrained_model_dir, cfg.load_multimodal_path),
            os.path.join(args.pretrained_model_dir, cfg.load_swin_path))
        return trainer.eval_multimodal_only(sd, test_ds)

    print("Training from scratch...")
    train_ds, valid_ds = build_split("train"), build_split("val")
    from facialmmt_tpu_torch.data.affwild2 import AffwildDataset

    aux_ds = AffwildDataset(cfg.data.data_folder, cfg.data.anno_folder,
                            cfg.data.data_list_train)
    pretrained_swin = None
    if cfg.pretrained_backbone_path and os.path.exists(
            cfg.pretrained_backbone_path):
        from facialmmt_tpu_torch.checkpoint.torch_load import \
            load_pretrained_swin_backbone

        pretrained_swin = load_pretrained_swin_backbone(
            cfg.pretrained_backbone_path)
    return trainer.run_multimodal(aux_ds, train_ds, valid_ds, test_ds,
                                  resume=bool(args.resume),
                                  pretrained_swin=pretrained_swin)


if __name__ == "__main__":
    from facialmmt_tpu_torch.utils.preemption import Preempted

    import torch.distributed as dist

    try:
        run()
    except Preempted:
        # the conventional SIGTERM exit code; the resume checkpoint is on disk
        sys.exit(143)
    finally:
        if dist.is_initialized():           # a torchrun rank
            dist.destroy_process_group()
