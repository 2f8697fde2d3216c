"""The slice as a whole: ``make`` -> ``batched_reset`` -> the fused
rollout in random mode, against the JAX XLA engine's random rollout.

Random streams differ by design (Philox here, threefry there), so the
comparison is distributional, with the measures of ``tools/dist_check.py``
(the normal approximation of the chi-square statistic) at fixed seeds, so
the test is deterministic: action frequencies, deliveries per step, episode
ends per step and respawn-cell uniformity.  The bounds are five standard
deviations.
"""
import importlib.util
import math
import os

import jax
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.parallel import build_batched_rollout_fn as jax_rollout_fn
from rware_tpu_torch.ops.fused_rollout import build_fused_rollout
from rware_tpu_torch.parallel import batched_reset, build_batched_rollout_fn
from tests.torch_ref import jax_states

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "dist_check",
    os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools", "dist_check.py"),
)
dist_check = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(dist_check)

# A 3x3 warehouse where random agents deliver often: one goal ringed by
# eight shelves, seven of them requested.
LAYOUT = """
xxx
xgx
xxx
"""
CONFIG = dict(n_agents=2, request_queue_size=7, layout=LAYOUT, max_steps=40,
              max_inactivity_steps=12)
B, T = 512, 64
Z_BOUND = 5.0


@pytest.fixture(scope="module")
def rollouts():
    jenv = rware_tpu.make(rware_tpu.WarehouseConfig(**CONFIG))
    env = rware_tpu_torch.make(rware_tpu_torch.WarehouseConfig(**CONFIG), device="cpu")
    _, jtraj = jax.jit(jax_rollout_fn(jenv, n_steps=T))(
        jax_states(jenv, B, seed=0), jax.random.split(jax.random.key(1), B)
    )
    states, _ = batched_reset(env, 0, B)
    final, traj = build_batched_rollout_fn(env, n_steps=T)(states, 1)
    jtraj = jax.tree.map(np.asarray, jtraj)
    return env, states, final, traj, jtraj


def _rate_z(k1, n1, k2, n2):
    """z of the difference of two binomial rates."""
    p = (k1 + k2) / (n1 + n2)
    sigma = math.sqrt(max(p * (1 - p), 1e-12) * (1 / n1 + 1 / n2))
    return (k1 / n1 - k2 / n2) / sigma


def test_fused_rollout_random_mode_equals_batched_rollout(rollouts):
    """K1's plain version and the batched rollout draw the same Philox
    stream: identical final states, reward sums and episode counts."""
    env, states, final, traj, _ = rollouts
    roll = build_fused_rollout(env.config, T)
    state, rew, epis = roll(states, 1)
    for f in ("agent_x", "agent_y", "agent_dir", "agent_carrying", "shelf_x", "shelf_y",
              "request_queue", "cur_steps", "cur_inactive_steps"):
        assert torch.equal(getattr(state, f), getattr(final, f)), f
    assert torch.equal(rew, traj.rewards.sum(0))
    assert torch.equal(epis, traj.dones.sum(0).to(torch.int32))


def test_action_frequencies_uniform(rollouts):
    _, _, _, traj, jtraj = rollouts
    for actions in (traj.actions.numpy(), jtraj.actions):
        counts = np.bincount(actions.reshape(-1), minlength=5)
        _, _, z = dist_check._chi2_z(counts)
        assert abs(z) < Z_BOUND, counts


def test_deliveries_per_step_match_jax(rollouts):
    _, _, _, traj, jtraj = rollouts
    k1 = int(traj.info["deliveries"].sum())
    k2 = int(np.asarray(jtraj.info["deliveries"]).sum())
    assert k1 > 100 and k2 > 100, (k1, k2)  # the layout delivers often
    assert abs(_rate_z(k1, B * T, k2, B * T)) < Z_BOUND, (k1, k2)


def test_episode_ends_per_step_match_jax(rollouts):
    _, _, _, traj, jtraj = rollouts
    k1, k2 = int(traj.dones.sum()), int(jtraj.dones.sum())
    assert k1 > 500 and k2 > 500, (k1, k2)
    assert abs(_rate_z(k1, B * T, k2, B * T)) < Z_BOUND, (k1, k2)
    # episode length = steps between ends; both engines cap it at max_steps
    lengths = []
    for dones in (traj.dones.numpy(), jtraj.dones):
        ends = [np.flatnonzero(d) for d in dones.T]
        lengths.append(np.concatenate([np.diff(e) for e in ends if e.size > 1]))
    mean1, mean2 = (float(np.mean(l)) for l in lengths)
    se = math.sqrt(np.var(lengths[0]) / lengths[0].size + np.var(lengths[1]) / lengths[1].size)
    assert abs(mean1 - mean2) < Z_BOUND * se, (mean1, mean2)
    assert max(l.max() for l in lengths) <= CONFIG["max_steps"]


def test_respawn_cells_and_directions_uniform(rollouts):
    """After every episode end the next observation's self features hold the
    respawned (x, y) and direction: uniform over the 9 cells and 4 headings
    (per agent marginal of a draw without replacement)."""
    _, _, _, traj, jtraj = rollouts
    for obs, dones in ((traj.obs.numpy(), traj.dones.numpy()), (jtraj.obs, jtraj.dones)):
        respawned = obs[1:][dones[:-1]]  # (K, N, L)
        x, y = respawned[..., 0].astype(int), respawned[..., 1].astype(int)
        cells = np.bincount((y * 3 + x).reshape(-1), minlength=9)
        dirs = np.bincount(respawned[..., 3:7].argmax(-1).reshape(-1), minlength=4)
        assert cells.sum() > 1000
        for counts in (cells, dirs):
            _, _, z = dist_check._chi2_z(counts)
            assert abs(z) < Z_BOUND, counts
