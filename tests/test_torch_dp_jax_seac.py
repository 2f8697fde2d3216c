"""Data-parallel recurrent SEAC-PPO against the JAX package's 2-device mesh
step, ``build_seac_gru_train_step(collect_mode="pallas", interpret=True,
deterministic_collect=True, mesh=make_mesh(jax.devices()[:2]))``, on the
CPU: two gloo rank processes, each holding 1,024 of B=2,048 envs, from JAX's
parameters (biases made nonzero), optimizer state, env states and carry,
with JAX's E epoch offsets in [0, n_local) handed over; T=8, E=2, M=2, one
update.  The case and its checks are ``tests/test_torch_dp_jax.py``'s
(parameters within 0.05 * lr * P, rtol 1e-3; metrics within rtol 1e-2, atol
1e-4, ``approx_kl`` atol 2e-3 as ``tests/test_torch_seac_gru_train.py``)."""
import pytest
import torch

from tests.test_torch_dp_jax import check_against_jax, run_cases

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(("seac_gru",), str(tmp_path_factory.mktemp("dpjax_seac")))


def test_two_ranks_match_jax_mesh_step_seac_gru(runs):
    check_against_jax(runs, "seac_gru")
