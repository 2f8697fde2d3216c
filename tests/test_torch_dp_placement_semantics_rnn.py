"""The semantics of plain recurrent IPPO placed on a device mesh, on the
CPU: ``ippo_rnn.build_rnn_train_step`` with its runner placed as
``train.py:291-303`` places it over ``jax.devices()[:2]`` (the carry split
with the env states) against the unplaced step (tiny-2ag, embed and GRU 32,
B=32, T=8, E=2, M=2; compiled without XLA's excess precision).  The collect
is bit for bit; the update differs in the order of XLA's float sums, so
the parameters are held within ``PLACED_TOL * lr`` (1.5e-7, 5e-4 lr,
apart on the CPU) and the metrics within rtol 1e-4 (``pg_loss`` 1e-5
apart).  Plain IPPO's and SEAC A2C's are in
``tests/test_torch_dp_placement_semantics.py``.
"""
import jax
import numpy as np

from rware_tpu.models import ippo as jax_ippo
from tests.test_torch_dp_placement_semantics import _bits, _mesh, _step, place
from tests.torch_ref import jit_bf16_exact

PLACED_TOL = 0.01  # times lr


def test_jax_placed_rnn_ippo_step_matches_unplaced():
    runner, step = _step("rnn_ippo")
    new, metrics = jit_bf16_exact(step, runner)
    placed, pmetrics = jit_bf16_exact(step, place(runner, _mesh()))
    collected = (new.env_states, new.obs, new.carry)
    for a, b in zip(_bits(collected), _bits((placed.env_states, placed.obs, placed.carry))):
        assert a.tobytes() == b.tobytes()
    lr = jax_ippo.IPPOConfig().lr
    for a, b in zip(jax.tree.leaves(new.params), jax.tree.leaves(placed.params)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=PLACED_TOL * lr)
    assert set(metrics) == set(pmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(pmetrics[k]), float(v), rtol=1e-4, err_msg=k)
    assert float(metrics["entropy"]) > 0  # the step ran
