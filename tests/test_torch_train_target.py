"""The port's target-task train steps against the JAX package on the CPU:
the second half of tests/test_torch_train.py (same config, weights, batch and
tolerances; a file of its own so that the two halves run side by side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facialmmt_tpu.train import steps as jsteps
from facialmmt_tpu_torch.train import steps as psteps
from tests.test_models import make_multimodal_batch
from tests.test_torch_train import Pair, _torch_batch, nodrop_config


@pytest.mark.parametrize("kind", ["target", "joint", "accum_joint"])
def test_target_step_matches_jax(rng, kind):
    """Three consecutive target steps from the same weights and batch: the
    default step (two-optimizer coupling: Swin's weights stay, its BatchNorm
    statistics move), the joint step, and the microbatch step (M = 2) as the
    trainer uses it, with joint training."""
    cfg = nodrop_config()
    joint = kind.endswith("joint")
    accum = kind.startswith("accum")
    micros = [make_multimodal_batch(np.random.default_rng(7 + i), cfg, b=2)
              for i in range(2)]
    batch = ({k: jnp.stack([m[k] for m in micros]) for k in micros[0]}
             if accum else micros[0])
    pair = Pair(rng, cfg, micros[0])
    jmake = (jsteps.make_multimodal_train_step_accum if accum
             else jsteps.make_multimodal_train_step)
    pmake = (psteps.make_multimodal_train_step_accum if accum
             else psteps.make_multimodal_train_step)
    jstep = jax.jit(jmake(pair.jmodel, pair.swin_tx, pair.mm_tx,
                          swin_from_target=joint))
    pstep = pmake(pair.pmodel, swin_from_target=joint,
                  compute_dtype="float32")
    swin_before = {k: v.clone() for k, v in
                   pair.pmodel.swin_model.state_dict().items()}
    for i in range(3):
        pair.jstate, jloss = jstep(pair.jstate, batch, jax.random.PRNGKey(i))
        ploss = pstep(pair.pstate, _torch_batch(batch))
        assert abs(float(ploss) - float(jloss)) <= 1e-5, (kind, i)
        pair.hold_state(f"{kind} step {i + 1}")
    assert pair.pstate.mm_step == 3
    assert pair.pstate.swin_step == (3 if joint else 0)
    after = pair.pmodel.swin_model.state_dict()
    moved = {k for k in after if not torch.equal(after[k], swin_before[k])}
    params = {k for k, _ in pair.pmodel.swin_model.named_parameters()}
    stats = {"swin.output_layer.3.running_mean",
             "swin.output_layer.3.running_var"}
    assert stats <= moved
    assert bool(moved & params) == joint
