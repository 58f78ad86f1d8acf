"""The port's models and weight bridge against the JAX package on the CPU.

JAX parameters are drawn from a numpy seed (tests/test_torch_ops.py::
random_params), carried over by checkpoint/from_jax.py, and loaded with
strict=True; the same inputs go through both forwards (XLA path, float32,
'highest' matmul precision).  Tolerance atol 1e-4 / rtol 1e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from facialmmt_tpu.config import (FacialMMTConfig, RuntimeConfig, SwinConfig,
                                  TextEncoderConfig)
from facialmmt_tpu_torch.checkpoint import from_jax
from tests.test_models import make_multimodal_batch
from tests.test_torch_ops import TOL, T, bridged, random_params
from tests.torch_bridge import port_config


def _load(module, sd):
    module.load_state_dict({k: torch.tensor(np.asarray(v))
                            for k, v in sd.items()}, strict=True)
    return module.eval()


def _tiny(**kw):
    cfg = FacialMMTConfig.tiny()
    return cfg.replace(runtime=RuntimeConfig(deterministic_gumbel=True), **kw)


@pytest.mark.parametrize("model_type", ["roberta", "bert"])
def test_text_encoder_matches_jax(rng, model_type):
    from facialmmt_tpu.models.text_encoder import TextEncoder as J
    from facialmmt_tpu_torch.models.text_encoder import TextEncoder as P

    cfg = TextEncoderConfig.tiny(model_type)
    ids = rng.integers(2, cfg.vocab_size, size=(3, 20)).astype(np.int32)
    mask = np.ones((3, 20), np.int32)
    ids[1, 12:] = cfg.pad_token_id
    mask[1, 12:] = 0
    mask[2, :] = 0                      # a fully padded dialogue
    ids[2, :] = cfg.pad_token_id
    jm = J(cfg)
    v = random_params(jm, rng, ids, mask)
    tm = P(port_config(cfg)).eval()
    tm.load_state_dict(bridged(from_jax._text_encoder, v["params"]),
                       strict=True)
    with torch.no_grad():
        got = tm(T(ids), T(mask)).numpy()
    want = np.asarray(jax.jit(jm.apply)(v, ids, mask))
    np.testing.assert_allclose(got, want, **TOL)


def test_swin_fer_matches_jax(rng):
    """Two stages, each with a shifted block where the resolution allows one
    (stage 0: 8x8 tokens in 4x4 windows, nW = 4) and the whole-input window at
    stage 1; raster patch merging; BatchNorm head with running stats."""
    from facialmmt_tpu.models.swin_fer import SwinForAffwildClassification as J
    from facialmmt_tpu_torch.models.swin_fer import \
        SwinForAffwildClassification as P

    swin = SwinConfig(img_size=32, patch_size=4, embed_dim=8, depths=(2, 2),
                      num_heads=(2, 4), window_size=4, drop_path_rate=0.0,
                      out_feature_dim=16)
    cfg = _tiny(swin=swin)
    imgs = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    jm = J(cfg)
    v = random_params(jm, rng, imgs)
    tm = _load(P(port_config(cfg)), from_jax.swin_fer_state_dict(v))
    assert tm.swin.layers[0].blocks[1].shift == 2
    assert tm.swin.layers[0].blocks[1].attn_mask.shape == (4, 16, 16)
    assert tm.swin.layers[1].blocks[1].shift == 0
    fwd = jax.jit(lambda v, x: (jm.apply(v, x),
                                jm.apply(v, x, is_trg_task=True)))
    want_logits, want_probs = fwd(v, imgs)
    with torch.no_grad():
        np.testing.assert_allclose(tm(T(imgs)).numpy(),
                                   np.asarray(want_logits), **TOL)
        np.testing.assert_allclose(tm(T(imgs), is_trg_task=True).numpy(),
                                   np.asarray(want_probs), **TOL)


def _multimodal_args(rng, cfg, b=3):
    batch = make_multimodal_batch(rng, cfg, b=b, num_dia=2)
    d = cfg.data
    vis = rng.normal(size=(b, d.vision_utt_max_len, cfg.vision_emb_dim))
    vmask = np.ones((b, d.vision_utt_max_len), np.int32)
    vmask[0, 3:] = 0
    amask = np.ones((b, d.audio_utt_max_len), np.int32)
    amask[1, 5:] = 0
    args = [np.asarray(batch[k]) for k in ("dia_input_ids", "dia_input_mask",
                                           "dia_sep_mask")]
    args += [np.asarray(batch["audio_inputs"]), amask,
             vis.astype(np.float32), vmask, np.asarray(batch["utt_in_dia_idx"]),
             np.asarray(batch["dia_idx"])]
    return args


def test_multimodal_matches_jax(rng):
    from facialmmt_tpu.models.multimodal import \
        MultiModalTransformerForClassification as J
    from facialmmt_tpu_torch.models.multimodal import \
        MultiModalTransformerForClassification as P

    cfg = _tiny()
    args = _multimodal_args(rng, cfg)
    jm = J(cfg)
    v = random_params(jm, rng, *args)
    tm = _load(P(port_config(cfg)), from_jax.multimodal_state_dict(v))
    with torch.no_grad():
        got = tm(*[T(a) for a in args]).numpy()
    want = np.asarray(jax.jit(jm.apply)(v, *args))
    np.testing.assert_allclose(got, want, **TOL)


def test_pipeline_matches_jax(rng):
    """The whole eval forward: Swin FER -> gumbel (deterministic) -> scatter
    -> frame filter -> fusion model."""
    from facialmmt_tpu.models.pipeline import FacialMMTPipeline as J
    from facialmmt_tpu_torch.models.pipeline import FacialMMTPipeline as P

    cfg = _tiny()
    batch = {k: np.array(v) for k, v in
             make_multimodal_batch(rng, cfg, b=3).items()}
    batch["face_utt_id"][-2:] = -1          # two pad slots
    batch["n_faces"][-1] = 2
    jm = J(cfg)
    v = random_params(jm, rng, batch)
    tm = _load(P(port_config(cfg)), from_jax.pipeline_state_dict(v))
    with torch.no_grad():
        got = tm({k: T(a) for k, a in batch.items()}).numpy()
    want = np.asarray(jax.jit(jm.apply)(v, batch))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("plm_name,text", [
    ("roberta-large", TextEncoderConfig.tiny("roberta")),
    ("bert-large", TextEncoderConfig.tiny("bert"))], ids=["roberta", "bert"])
def test_bridge_matches_torch_export(rng, plm_name, text):
    """from_jax equals torch_export key for key and value for value, covers
    every parameter and buffer of the port, and loads with strict=True."""
    from facialmmt_tpu.checkpoint.torch_export import (export_multimodal,
                                                       export_swin_fer)
    from facialmmt_tpu.models.pipeline import FacialMMTPipeline as J
    from facialmmt_tpu_torch.models.pipeline import FacialMMTPipeline as P

    cfg = _tiny(plm_name=plm_name, text=text)
    cfg = dataclasses.replace(
        cfg, swin=dataclasses.replace(cfg.swin, depths=(2, 2)))
    batch = make_multimodal_batch(rng, cfg, b=2)
    v = random_params(J(cfg), rng, batch)
    params, stats = v["params"], v["batch_stats"]
    mm = from_jax.multimodal_state_dict({"params": params["multimodal"]},
                                        plm_name)
    sw = from_jax.swin_fer_state_dict({"params": params["swin_model"],
                                       "batch_stats": stats["swin_model"]})
    for ours, theirs in ((mm, export_multimodal({"params": params["multimodal"]},
                                                plm_name)),
                         (sw, export_swin_fer({"params": params["swin_model"],
                                               "batch_stats":
                                                   stats["swin_model"]}))):
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype, k
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    port = P(port_config(cfg))
    sd = from_jax.pipeline_state_dict(v, plm_name)
    assert sorted(sd) == sorted(port.state_dict())
    _load(port, sd)
    assert hasattr(port.multimodal, "roberta" if "roberta" in plm_name
                   else "bert")


def test_swin_train_mode_batch_stats_match_flax(rng):
    """A train-mode forward at batch 4: logits (BatchNorm on batch
    statistics) and the updated running statistics match flax, whose running
    variance takes the BIASED batch variance; torch.nn.BatchNorm1d would
    store the unbiased one, 4/3 of it at batch 4."""
    from facialmmt_tpu.models.swin_fer import SwinForAffwildClassification as J
    from facialmmt_tpu_torch.models.swin_fer import \
        SwinForAffwildClassification as P

    cfg = FacialMMTConfig.tiny()
    imgs = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    jm = J(cfg)
    v = random_params(jm, rng, imgs)
    tm = _load(P(port_config(cfg)), from_jax.swin_fer_state_dict(v)).train()
    bn = tm.swin.output_layer[3]
    var_before = bn.running_var.clone()
    got = tm(T(imgs)).detach().numpy()
    want, mutated = jm.apply(v, imgs, deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(0)},
                             mutable=["batch_stats"])
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    stats = mutated["batch_stats"]["swin"]["head_bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), **TOL)
    # what torch's own BatchNorm would have stored differs measurably
    batch_var = (bn.running_var - 0.9 * var_before) / 0.1
    unbiased = 0.9 * var_before + 0.1 * batch_var * 4 / 3
    assert float((unbiased - bn.running_var).abs().max()) > 1e-3
    assert int(bn.num_batches_tracked) == 0     # the update is by hand
    # use_running_average=True in train mode: running statistics, no update
    mean_before = bn.running_mean.clone()
    tm.swin(T(imgs), use_running_average=True)
    assert torch.equal(bn.running_mean, mean_before)
    # eval mode uses the running statistics
    tm.eval()
    got = tm(T(imgs)).detach().numpy()
    want = jm.apply({"params": v["params"], "batch_stats":
                     mutated["batch_stats"]}, imgs)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_pipeline_train_mode_paths_match_jax(rng):
    """aux_logits, fer_probs and a precomputed 'face_probs' entry, against
    the JAX pipeline with the same weights (eval mode, deterministic gumbel);
    stop_swin_gradient leaves Swin without gradients."""
    from facialmmt_tpu.models.pipeline import FacialMMTPipeline as J
    from facialmmt_tpu_torch.models.pipeline import FacialMMTPipeline as P

    cfg = FacialMMTConfig.tiny().replace(
        runtime=RuntimeConfig(deterministic_gumbel=True))
    batch = make_multimodal_batch(rng, cfg, b=2)
    jm = J(cfg)
    v = random_params(jm, rng, batch)
    tm = _load(P(port_config(cfg)), from_jax.pipeline_state_dict(v))
    tb = {k: T(a) for k, a in batch.items()}
    with torch.no_grad():
        np.testing.assert_allclose(
            tm.aux_logits(tb["faces"]).numpy(),
            np.asarray(jm.apply(v, batch["faces"], method=J.aux_logits)), **TOL)
        probs = tm.fer_probs(tb["faces"])
        np.testing.assert_allclose(
            probs.numpy(),
            np.asarray(jm.apply(v, batch["faces"], method=J.fer_probs)), **TOL)
        full = tm(tb).numpy()
        pre = tm(dict({k: a for k, a in tb.items() if k != "faces"},
                      face_probs=probs)).numpy()
    np.testing.assert_allclose(pre, full, rtol=1e-6, atol=1e-6)
    tm.train()
    tm(tb, stop_swin_gradient=True).sum().backward()
    assert all(p.grad is None for p in tm.swin_model.parameters())
    assert any(p.grad is not None for p in tm.multimodal.parameters())
