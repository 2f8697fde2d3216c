"""The port's CUDA kernels against their plain PyTorch versions on a GPU.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor the JAX package, so it also runs where only PyTorch
is installed; there the repository's ``tests/conftest.py`` (which sets up
JAX) is skipped::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""
import pytest
import torch

import rware_tpu_torch
from rware_tpu_torch.models import ActorCritic
from rware_tpu_torch.ops.fused_rollout import build_fused_collect, build_fused_rollout
from rware_tpu_torch.parallel import batched_reset

torch.set_num_threads(1)
pytestmark = [
    pytest.mark.gpu,
    pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA GPU"),
]
DEV = torch.device("cuda")

FIELDS = ("agent_x", "agent_y", "agent_dir", "agent_carrying", "agent_has_delivered",
          "shelf_x", "shelf_y", "request_queue", "cur_steps", "cur_inactive_steps")
ATOL = 2e-2  # value and logp: the bound the JAX collector is held to


@pytest.mark.parametrize("env_id", ["rware-medium-6ag-hard-v2", "rware-tiny-16ag-v2"])
@pytest.mark.parametrize("scripted", [True, False])
def test_fused_rollout_kernel_matches_plain(env_id, scripted):
    env = rware_tpu_torch.make(env_id, device=DEV, max_steps=40)
    states, _ = batched_reset(env, 2, 1000)
    roll = build_fused_rollout(env.config, 64, scripted=scripted)
    actions = None
    if scripted:
        gen = torch.Generator(device=DEV).manual_seed(0)
        actions = torch.randint(0, 5, (64, 1000, env.n_agents), generator=gen,
                                device=DEV, dtype=torch.int32)
    ks, kr, ke = roll(states, 3, actions)
    ps, pr, pe = roll.plain(states, 3, actions)
    assert roll.launches == 1
    for f in FIELDS:
        assert torch.equal(getattr(ks, f), getattr(ps, f)), f
    assert torch.equal(kr, pr) and torch.equal(ke, pe)


@pytest.mark.parametrize("deterministic", [True, False])
def test_fused_collect_kernel_matches_plain(deterministic):
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=DEV, max_steps=20)
    states, _ = batched_reset(env, 1, 1000)
    torch.manual_seed(0)
    policy = ActorCritic(env.config.flattened_obs_length).to()
    collect = build_fused_collect(env.config, 32, deterministic=deterministic)
    ks, ktraj = collect(states, policy, 2)
    ps, ptraj = collect.plain(states, policy, 2)
    assert collect.launches == 1
    for k in ("obs", "action", "reward", "done"):
        assert torch.equal(ktraj[k], ptraj[k]), k
    for k in ("value", "logp"):
        assert float((ktraj[k] - ptraj[k]).abs().max()) <= ATOL, k
    for f in FIELDS:
        assert torch.equal(getattr(ks, f), getattr(ps, f)), f


def test_fused_rollout_kernel_matches_cpu_plain():
    """The kernel on the card gives what the plain version gives on the
    CPU: the Philox stream does not depend on the device."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=DEV)
    states, _ = batched_reset(env, 0, 300)
    roll = build_fused_rollout(env.config, 40)
    ks, kr, ke = roll(states, 1)
    ps, pr, pe = roll.plain(states.map(lambda x: x.cpu()), 1)
    assert torch.equal(kr.cpu(), pr) and torch.equal(ke.cpu(), pe)
    for f in FIELDS:
        assert torch.equal(getattr(ks, f).cpu(), getattr(ps, f)), f


def test_kernels_reject_unsupported_devices_and_sizes():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=DEV)
    states, _ = batched_reset(env, 0, 8)
    roll = build_fused_rollout(env.config, 4, scripted=True)
    with pytest.raises(ValueError):
        roll(states, 0, torch.zeros((4, 8, 2), dtype=torch.int32))  # actions on the CPU
    with pytest.raises(ValueError):
        build_fused_collect(rware_tpu_torch.parse_env_id("rware-5s-tiny-2ag-v2"), 4)
