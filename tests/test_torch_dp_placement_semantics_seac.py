"""The semantics of SEAC-PPO's flat learner placed on a device mesh, on the
CPU: ``seac.build_seac_ppo_train_step(update_mode="xla")`` with its runner
placed as ``train.py:291-303`` places it over ``jax.devices()[:2]`` equals
the unplaced step bit for bit (tiny-2ag, hidden (32, 32), B=32, T=8, E=2,
M=2; compiled without XLA's excess precision).  Plain IPPO's and SEAC
A2C's are in ``tests/test_torch_dp_placement_semantics.py``.
"""
from tests.test_torch_dp_placement_semantics import _equal_bits, _mesh, _step, place
from tests.torch_ref import jit_bf16_exact


def test_jax_placed_seac_ppo_step_equals_unplaced():
    runner, step = _step("seac_ppo")
    unplaced = jit_bf16_exact(step, runner)
    placed = jit_bf16_exact(step, place(runner, _mesh()))
    assert _equal_bits(unplaced, placed)
    assert float(unplaced[1]["entropy"]) > 0  # the step ran
