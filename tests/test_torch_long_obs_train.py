"""One update of the port's fused IPPO learner against the JAX package's
``build_pallas_train_step(interpret=True, deterministic_collect=True)`` at
sensor range 5 (``rware-5s-tiny-2ag-v2``, 855 features a row), on the CPU:
the checks of ``tests/test_torch_train.py``'s tiny-2ag update on the same
construction (``_step_pair``).  The collector's plan there reads the weights
from device memory (its only route for this id).

The trajectory is equal; the update within ``0.05 * lr * P``, as at tiny-2ag.
The advantages keep tiny-2ag's rule (within 1e-5 wherever the stored and last
values agree with JAX's to 1e-6, 98% of the envs or more) with the last values
held to the stored values' 1e-3: over 855 features one of the 2,048 last
values flips a hidden unit's bf16 rounding (5.6e-4), which at tiny-2ag none
did.
"""
import pytest
import torch

from tests import test_torch_train as tiny

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def long_step_pair():
    return tiny._step_pair("rware-5s-tiny-2ag-v2")


def test_collector_takes_the_device_memory_route(long_step_pair):
    plan = long_step_pair["step"].collect.plan
    assert plan.weights_global and plan.kx == 0


def test_trajectory_equals_jax_at_sensor_range_5(long_step_pair):
    tiny.test_trajectory_equals_jax(long_step_pair)


def test_advantages_match_jax_at_sensor_range_5(long_step_pair):
    tiny._check_advantages(long_step_pair, 1e-3)


def test_update_matches_jax_at_sensor_range_5(long_step_pair):
    tiny.test_update_matches_jax(long_step_pair)


def test_update_moved_params_at_sensor_range_5(long_step_pair):
    tiny.test_update_moved_params_and_runner_is_new(long_step_pair)
