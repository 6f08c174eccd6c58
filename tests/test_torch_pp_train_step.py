"""The YOLaT++ train step of the port against yolat_tpu's, on the CPU, on
the three routes through the primitive level and with the fused pool head:
the loss, `prim_at_node`, the BatchNorm statistics and the step-1
gradients, then the parameters after 3 Adam steps on one batch of the
synthetic dataset packed by each package's own loader. Inputs, helpers and
the tolerances, with why each is what it is: tests/torch_pp_train_common.py.
"""

import pytest

from torch_pp_train_common import (_configs, _jax_state, batches,
                                   train_step_parity)

__all__ = ["batches"]  # the module fixture the test takes


@pytest.mark.parametrize("route,fused", [
    ("per_edge", False), ("banded", False), ("factored", False),
    ("per_edge", True)])
def test_train_step_matches_jax(batches, route, fused):
    jb, pb = batches
    jcfg, cfg = _configs(route, fused_head_train=fused)
    tx, state = _jax_state(jcfg, jb)
    train_step_parity(jb, pb, route, jcfg, cfg, tx, state, jit=True)
