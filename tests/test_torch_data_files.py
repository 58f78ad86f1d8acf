"""The port's file layer against the JAX package's on the CPU: text
preprocessing, the MELD and Aff-Wild2 datasets (array by array, bit for bit,
decoded faces included: both build faceloader.cpp from the same source), the
npz cache, the errors, the decoder's choice, the run records, and the
pretrained loaders and grafts (the HF text tower written by `transformers`
from a tiny config, the Ms-Celeb-style `backbone.*` Swin file) against
JAX's converters, at atol 0 after the layout change.  Same seed-made files
(tests/fixtures.py) on both sides.
"""

import dataclasses
import json
import os
import pickle
import time

import numpy as np
import pytest
import torch

from facialmmt_tpu.data import affwild2 as jax_affwild2
from facialmmt_tpu.data import meld as jax_meld
from facialmmt_tpu.data import text_prep as jax_text_prep
from facialmmt_tpu_torch import native
from facialmmt_tpu_torch.data import affwild2, meld, text_prep
from tests.fixtures import (WhitespaceTokenizer, write_affwild_fixture,
                            write_meld_fixture)

MAX_SEQ = 64


def _text(pkg, fix, is_roberta, max_seq=MAX_SEQ):
    prep = pkg.MeldTextPreprocessor(WhitespaceTokenizer(is_roberta),
                                    is_roberta, max_seq)
    feats = prep.preprocess_split(fix["csv"], fix["text_json"])
    return pkg.MeldTextPreprocessor.to_arrays(feats)


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    root = tmp_path_factory.mktemp("files")
    out = write_meld_fixture(str(root), split="test", num_dia=4,
                             utts_per_dia=3, seed=5, faces_per_utt=4)
    out["root"] = str(root)
    return out


# ------------------------------------------------------------------- text --

@pytest.mark.parametrize("is_roberta, max_seq", [(True, 64), (False, 64),
                                                 (True, 16), (False, 12)])
def test_text_arrays_equal_jax(fix, is_roberta, max_seq):
    """Both separator layouts, with and without truncation."""
    got = _text(text_prep, fix, is_roberta, max_seq)
    want = _text(jax_text_prep, fix, is_roberta, max_seq)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_truncate_and_join_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        toks = [[f"t{j}" for j in range(int(rng.integers(0, 9)))]
                for _ in range(int(rng.integers(1, 5)))]
        budget = int(rng.integers(0, 20))
        got = text_prep.truncate_seq_pair([list(t) for t in toks], budget)
        assert got == jax_text_prep.truncate_seq_pair(
            [list(t) for t in toks], budget)
        for is_roberta in (True, False):
            assert text_prep.join_dialogue(got, is_roberta) == \
                jax_text_prep.join_dialogue(got, is_roberta)


def test_make_text_dia_equals_jax(tmp_path):
    """Dialogues in the CSV's order, not sorted."""
    path = str(tmp_path / "x_sent_emo.csv")
    with open(path, "w") as f:
        f.write("Dialogue_ID,Utterance_ID,Utterance\n2,0,a\n2,1,b\n0,0,c\n")
    got = text_prep.make_text_dia(path)
    assert got == jax_text_prep.make_text_dia(path)
    assert list(got) == ["2", "0"]


# --------------------------------------------------------------- datasets --

def test_multimodal_batches_equal_jax(fix):
    """Every array of get_batch, faces_raw included, bit for bit; batches
    that repeat a dialogue, span several and pad the dialogue slots."""
    ids, mask, sep = _text(text_prep, fix, True)
    port = meld.MeldMultimodalDataset(fix["root"], "test", meld.MeldTextArrays(
        ids, mask, sep), cache=False)
    jax_ds = jax_meld.MeldMultimodalDataset(
        fix["root"], "test", jax_meld.MeldTextArrays(ids, mask, sep),
        cache=False)
    assert len(port) == len(jax_ds) == fix["n_utt"]
    assert port.audio_max_utt_len == jax_ds.audio_max_utt_len
    assert port.vision_feat_dim == jax_ds.vision_feat_dim
    for idx, cap in (([0, 1, 2, 3], 64), ([5, 5, 11, 0, 7], 32),
                     (list(range(12)), 64), ([9], 4)):
        got = port.get_batch(idx, face_capacity=cap)
        want = jax_ds.get_batch(idx, face_capacity=cap)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["faces_raw"][:int(got["n_faces"].sum())].any()


def test_vision_batches_equal_jax(fix):
    port = meld.MeldVisionDataset(fix["root"], "test", cache=False)
    jax_ds = jax_meld.MeldVisionDataset(fix["root"], "test", cache=False)
    assert (port.max_utt_len, port.feat_dim) == (jax_ds.max_utt_len,
                                                 jax_ds.feat_dim)
    for idx in ([0, 3, 4], list(range(len(port)))):
        got, want = port.get_batch(idx), jax_ds.get_batch(idx)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_face_capacity_error_as_jax(fix):
    ids, mask, sep = _text(text_prep, fix, True)
    port = meld.MeldMultimodalDataset(fix["root"], "test",
                                      meld.MeldTextArrays(ids, mask, sep))
    jax_ds = jax_meld.MeldMultimodalDataset(
        fix["root"], "test", jax_meld.MeldTextArrays(ids, mask, sep))
    idx = [0, 1, 3]
    needed = int(port.get_batch(idx, face_capacity=64)["n_faces"].sum())
    with pytest.raises(meld.FaceCapacityError) as got:
        port.get_batch(idx, face_capacity=needed - 1)
    with pytest.raises(jax_meld.FaceCapacityError) as want:
        jax_ds.get_batch(idx, face_capacity=needed - 1)
    assert (got.value.required, got.value.capacity) == \
        (want.value.required, want.value.capacity) == (needed, needed - 1)
    assert str(got.value) == str(want.value)


def test_face_mask_mismatch_raises_as_jax(tmp_path):
    write_meld_fixture(str(tmp_path), split="test", seed=1)
    pkl_path = os.path.join(str(tmp_path), "T+A+V", "meld_test_vision_utt.pkl")
    with open(pkl_path, "rb") as f:
        data = pickle.load(f)
    data["test"]["vision_utt_mask"][0][:] = 1
    with open(pkl_path, "wb") as f:
        pickle.dump(data, f)
    arrays = (np.zeros((3, 8), np.int32), np.ones((3, 8), np.int32),
              np.zeros((3, 8), np.int32))
    with pytest.raises(ValueError) as got:
        meld.MeldMultimodalDataset(str(tmp_path), "test",
                                   meld.MeldTextArrays(*arrays), cache=False)
    with pytest.raises(ValueError) as want:
        jax_meld.MeldMultimodalDataset(str(tmp_path), "test",
                                       jax_meld.MeldTextArrays(*arrays),
                                       cache=False)
    assert "disagree with the pkl vision mask" in str(got.value)
    assert str(got.value) == str(want.value)


def test_npz_cache_roundtrip_invalidation_and_jax_format(tmp_path):
    """The port writes the cache, reads it back, rebuilds it when a pickle
    is newer, and reads the cache the JAX package writes (one format)."""
    write_meld_fixture(str(tmp_path), split="test", seed=3)
    base = os.path.join(str(tmp_path), "T+A+V")
    cache = os.path.join(base, "meld_test_features.npz")
    arrays = meld.MeldTextArrays(np.zeros((3, 8), np.int32),
                                 np.ones((3, 8), np.int32),
                                 np.zeros((3, 8), np.int32))
    ds1 = meld.MeldMultimodalDataset(str(tmp_path), "test", arrays)
    assert os.path.exists(cache)
    built = os.path.getmtime(cache)
    ds2 = meld.MeldMultimodalDataset(str(tmp_path), "test", arrays)
    assert os.path.getmtime(cache) == built          # read, not rebuilt
    for name in ("audio", "audio_mask", "vision", "vision_mask", "labels"):
        np.testing.assert_array_equal(getattr(ds1, name), getattr(ds2, name))

    audio_pkl = os.path.join(base, "meld_test_audio_utt.pkl")
    with open(audio_pkl, "rb") as f:
        data = pickle.load(f)
    data["test"]["audio"] = np.asarray(data["test"]["audio"]) + 1.0
    time.sleep(0.01)
    with open(audio_pkl, "wb") as f:
        pickle.dump(data, f)
    ds3 = meld.MeldMultimodalDataset(str(tmp_path), "test", arrays)
    np.testing.assert_array_equal(ds3.audio, ds1.audio + 1.0)

    os.remove(cache)
    jax_meld.MeldMultimodalDataset(
        str(tmp_path), "test", jax_meld.MeldTextArrays(
            arrays.input_ids, arrays.input_mask, arrays.sep_mask))
    jax_built = os.path.getmtime(cache)
    ds4 = meld.MeldMultimodalDataset(str(tmp_path), "test", arrays)
    assert os.path.getmtime(cache) == jax_built
    np.testing.assert_array_equal(ds4.audio, ds3.audio)

    v1 = meld.MeldVisionDataset(str(tmp_path), "test")
    assert os.path.exists(os.path.join(str(tmp_path), "V",
                                       "meld_test_vision_utt.pkl.npz"))
    v2 = meld.MeldVisionDataset(str(tmp_path), "test")
    np.testing.assert_array_equal(v1.features, v2.features)


def test_affwild_equals_jax(tmp_path):
    aux = write_affwild_fixture(str(tmp_path), num_videos=3, frames=6,
                                seed=2)
    got = affwild2.generate_data_list(aux["file_folder"], aux["anno_folder"])
    want = jax_affwild2.generate_data_list(aux["file_folder"],
                                           aux["anno_folder"])
    assert got == want and len(got) > 3
    assert affwild2.ABAW_TO_MELD == jax_affwild2.ABAW_TO_MELD
    # one side writes the list file, the other reads it
    list_path = str(tmp_path / "list.txt")
    port = affwild2.AffwildDataset(aux["file_folder"], aux["anno_folder"],
                                   data_list=list_path)
    assert os.path.isfile(list_path)
    jax_ds = jax_affwild2.AffwildDataset(aux["file_folder"],
                                         data_list=list_path)
    assert port.data_list == jax_ds.data_list
    idx = list(range(len(port)))[::-1]
    (gi, gl), (wi, wl) = port.get_batch(idx), jax_ds.get_batch(idx)
    assert gi.dtype == wi.dtype == np.uint8 and gi.shape[1:] == (112, 112, 3)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)


# ---------------------------------------------------------------- decoder --

def test_cv2_fallback_within_one_level(fix, monkeypatch):
    """Without the native library the decoder reads with cv2, as the JAX
    package's fallback does: within one level of the native decode."""
    paths = [p for ps in json.load(open(os.path.join(
        fix["base"], "test_facseqs_160_paths_final.json"))).values()
        for p in ps]
    native_px = native.decode_images(paths, 160)
    assert native.decoder_name() == "native"
    monkeypatch.setattr(native, "load_library", lambda: None)
    assert native.decoder_name() == "cv2"
    cv2_px = native.decode_images(paths, 160)
    assert np.abs(cv2_px.astype(int) - native_px.astype(int)).max() <= 1
    small = native.decode_images(paths[:2], 112, upscale_interp="area")
    assert small.shape == (2, 112, 112, 3) and small.any()


def test_no_decoder_raises_and_names_both(fix, monkeypatch):
    import builtins

    monkeypatch.setattr(native, "load_library", lambda: None)
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(RuntimeError, match="native faceloader.*cv2"):
        native.decode_images(["x.jpg"], 160)


# ----------------------------------------------------------- run records --

def test_metric_writer_records_as_jax(tmp_path, capsys):
    from facialmmt_tpu.utils.observability import MetricWriter as JaxWriter
    from facialmmt_tpu_torch.utils.observability import MetricWriter

    lines = {}
    for name, cls in (("port", MetricWriter), ("jax", JaxWriter)):
        w = cls(str(tmp_path / name / "m.jsonl"))
        w.log_train("SRC", 1, 5, 10, 12.5, 0.75)
        w.log_train("TRG", 1, 3, 4, 20.0, 1.25)
        w.log_eval(1, 0.01, 0.5)
        w.log_test(0.625)
        w.close()
        recs = [json.loads(x) for x in open(tmp_path / name / "m.jsonl")]
        lines[name] = [{k: v for k, v in r.items() if k != "time"}
                       for r in recs]
        lines[name + "_out"] = capsys.readouterr().out
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 4
    assert lines["port_out"] == lines["jax_out"]


# ------------------------------------------------------- pretrained files --

def _tiny_hf(path, kind, tcfg, fmt):
    """An HF directory written by transformers from the tiny text config."""
    from transformers import BertConfig, BertModel, RobertaConfig, RobertaModel

    config_cls, model_cls = ((RobertaConfig, RobertaModel) if kind == "roberta"
                             else (BertConfig, BertModel))
    torch.manual_seed(0)
    hf = model_cls(config_cls(
        vocab_size=tcfg.vocab_size, hidden_size=tcfg.hidden_size,
        num_hidden_layers=tcfg.num_layers, num_attention_heads=tcfg.num_heads,
        intermediate_size=tcfg.intermediate_size,
        max_position_embeddings=tcfg.max_position_embeddings,
        type_vocab_size=tcfg.type_vocab_size, pad_token_id=tcfg.pad_token_id,
        layer_norm_eps=tcfg.layer_norm_eps)).eval()
    if fmt == "bin":
        hf.save_pretrained(path, safe_serialization=False)
    elif fmt == "shards":
        hf.save_pretrained(path, max_shard_size="40KB")
    else:
        hf.save_pretrained(path)
    return hf


@pytest.mark.parametrize("kind, fmt", [("roberta", "bin"),
                                       ("bert", "safetensors"),
                                       ("roberta", "shards")])
def test_hf_text_tower_graft_equals_jax(tmp_path, kind, fmt):
    """The tower grafted by the port's trainer equals the tree JAX's
    _pretrained_text_tower converts, tensor for tensor; the pooler is
    dropped; a directory of other dimensions raises with JAX's message."""
    from facialmmt_tpu.config import FacialMMTConfig as JaxConfig
    from facialmmt_tpu.train.trainer import Trainer as JaxTrainer
    from facialmmt_tpu.utils.observability import MetricWriter as JaxWriter
    from facialmmt_tpu_torch.checkpoint import from_jax
    from facialmmt_tpu_torch.checkpoint.torch_load import load_hf_text_tower
    from facialmmt_tpu_torch.train.trainer import Trainer
    from tests.torch_bridge import port_config

    plm = "roberta-large" if kind == "roberta" else "bert-large"
    jcfg = JaxConfig.tiny()
    jcfg = jcfg.replace(plm_name=plm, text=type(jcfg.text).tiny(kind),
                        pretrained_text_model_path=str(tmp_path / "plm"))
    hf = _tiny_hf(str(tmp_path / "plm"), kind, jcfg.text, fmt)
    if fmt == "shards":
        assert os.path.isfile(tmp_path / "plm" / "model.safetensors.index.json")

    want = {}
    from_jax._text_encoder(
        JaxTrainer(jcfg, JaxWriter())._pretrained_text_tower(), want,
        f"multimodal.{kind}")
    trainer = Trainer(port_config(jcfg), device="cpu")
    model = trainer._build_model()
    trainer._graft_pretrained(model, None)
    got = {k: v for k, v in model.state_dict().items()
           if k.startswith(f"multimodal.{kind}.")}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(
        got[f"multimodal.{kind}.encoder.layer.0.attention.self.query.weight"]
        .numpy(), hf.encoder.layer[0].attention.self.query.weight.detach())

    wrong = dataclasses.replace(jcfg.text, hidden_size=128, num_heads=8)
    with pytest.raises(ValueError) as got_err:
        load_hf_text_tower(str(tmp_path / "plm"), port_config(wrong), kind)
    from facialmmt_tpu.checkpoint.torch_convert import \
        load_pretrained_hf_text_tower

    with pytest.raises(ValueError) as want_err:
        load_pretrained_hf_text_tower(str(tmp_path / "plm"), wrong)
    assert "hidden_size: ours 128 vs HF 64" in str(got_err.value)
    assert str(got_err.value) == str(want_err.value)


def test_text_tower_path_checks(tmp_path, capsys):
    """An empty path keeps a random tower: the trainer stays silent (it runs
    in-memory training too) and the command line's training warns once;
    a path that is not a directory raises."""
    from facialmmt_tpu_torch import main as port_main
    from facialmmt_tpu_torch.config import FacialMMTConfig
    from facialmmt_tpu_torch.train.trainer import Trainer

    cfg = FacialMMTConfig.tiny()
    assert Trainer(cfg, device="cpu")._pretrained_text_tower() is None
    assert "RANDOMLY" not in capsys.readouterr().out
    assert port_main.resolve_pretrained_text_dir(
        cfg.replace(do_eval=False), str(tmp_path)) == cfg.replace(
            do_eval=False)
    assert "RANDOMLY initialized" in capsys.readouterr().out
    (tmp_path / cfg.plm_name).mkdir()
    assert port_main.resolve_pretrained_text_dir(
        cfg.replace(do_eval=False), str(tmp_path)).pretrained_text_model_path \
        == str(tmp_path / cfg.plm_name)
    assert "RANDOMLY" not in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="not a directory"):
        Trainer(cfg.replace(pretrained_text_model_path=str(tmp_path / "no")),
                device="cpu")._pretrained_text_tower()


def test_backbone_graft_equals_jax(tmp_path):
    """A `backbone.*` Swin file (head keys beside it): the port's graft
    equals JAX's convert_pretrained_swin_backbone, parameters and running
    statistics; a file of other dimensions raises before anything is
    copied, listing the first six mismatches."""
    from facialmmt_tpu.checkpoint.torch_convert import (
        convert_pretrained_swin_backbone, load_torch_state_dict)
    from facialmmt_tpu.config import FacialMMTConfig as JaxConfig
    from facialmmt_tpu_torch.checkpoint import from_jax
    from facialmmt_tpu_torch.checkpoint.torch_load import \
        load_pretrained_swin_backbone
    from facialmmt_tpu_torch.config import FacialMMTConfig
    from facialmmt_tpu_torch.models.pipeline import FacialMMTPipeline
    from facialmmt_tpu_torch.train.trainer import Trainer, graft_subtree

    rng = np.random.default_rng(4)
    cfg = FacialMMTConfig.tiny()
    src = {k[len("swin_model.swin."):]: torch.tensor(
        rng.normal(size=tuple(v.shape)), dtype=v.dtype)
        if v.is_floating_point() else v
        for k, v in FacialMMTPipeline(cfg).state_dict().items()
        if k.startswith("swin_model.swin.")}
    torch.save({**{"backbone." + k: v for k, v in src.items()},
                "head.weight": torch.zeros(5, 16)}, tmp_path / "ms1m.pt")

    jax_tree = convert_pretrained_swin_backbone(
        load_torch_state_dict(str(tmp_path / "ms1m.pt")), JaxConfig.tiny())
    params = jax_tree["params"]["swin"]
    want = from_jax._apply(from_jax._swin_backbone_rules(
        params, (), "swin_model.swin"), params)
    stats = jax_tree["batch_stats"]["swin"]["head_bn"]
    want["swin_model.swin.output_layer.3.running_mean"] = stats["mean"]
    want["swin_model.swin.output_layer.3.running_var"] = stats["var"]

    trainer = Trainer(cfg, device="cpu")
    model = trainer._build_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer._graft_pretrained(
        model, load_pretrained_swin_backbone(str(tmp_path / "ms1m.pt")))
    after = model.state_dict()
    assert len(want) > 30
    for k in want:
        np.testing.assert_array_equal(after[k].numpy(), want[k], err_msg=k)
    untouched = [k for k in after if not k.startswith("swin_model.swin.")
                 or k.endswith(("relative_position_index", "attn_mask",
                                "num_batches_tracked"))]
    assert untouched and all(torch.equal(after[k], before[k])
                             for k in untouched)

    wrong = dict(src)
    wrong["patch_embed.proj.weight"] = torch.zeros(9, 3, 4, 4)
    del wrong["output_layer.2.bias"]
    wrong["extra.weight"] = torch.zeros(1)
    model2 = trainer._build_model()
    sd2 = {k: v.clone() for k, v in model2.state_dict().items()}
    with pytest.raises(ValueError, match=r"3 mismatch\(es\).*extra.weight: "
                       r"unexpected.*output_layer.2.bias: missing.*"
                       r"patch_embed.proj.weight: shape \(9, 3, 4, 4\)"):
        graft_subtree(model2, wrong, "swin_model.swin.", "pretrained Swin")
    assert all(torch.equal(v, sd2[k]) for k, v in model2.state_dict().items())
