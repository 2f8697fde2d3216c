"""SEAC-PPO's kernels on the CPU: the plain version of the per-agent gradient
kernel (K8, ``FusedSeacGrads``) against ``build_fused_seac_ppo_grads(
interpret=True)``, and the plain version of the per-agent collector (K2d,
``FusedCollectPerAgent``) against ``build_pallas_collect(policy=
"mlp_per_agent", interpret=True, deterministic=True)``.  The CUDA kernels run
only on a GPU (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

The JAX side is compiled without XLA's excess precision
(``tests/torch_ref.jit_bf16_exact``).  Tolerances: K8's gradients within 6%
of each leaf's largest |value| and its metrics within rtol 3e-2, atol 3e-3
(the bounds ``tests/test_pallas_update.py:258-268`` hold the Pallas kernel
to autodiff with; the two sides round to bf16 at the same places and differ
by float32 summation order).  K2d: observations exact in every env whose
actions agreed so far, values and logp within 2e-2, at least 99% of the
actions equal (a near-tie of two logits flips one now and then), rewards,
``done`` and the final state equal in the envs whose actions all agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.models import ActorCritic as FlaxActorCritic
from rware_tpu.ops.pallas_rollout import ENV_BLOCK, LANE, build_pallas_collect
from rware_tpu.ops.pallas_update import build_fused_seac_ppo_grads as jax_grads
from rware_tpu_torch import convert
from rware_tpu_torch.models import ActorCritic
from rware_tpu_torch.models.networks import BlockDims
from rware_tpu_torch.models.seac import seac_policies_of
from rware_tpu_torch.ops.fused_rollout import (
    build_fused_collect_per_agent,
    collect_plan,
)
from rware_tpu_torch.ops.fused_seac import build_fused_seac_grads
from rware_tpu_torch.ops.fused_update import metric_means, window_advstats
from rware_tpu_torch.parallel import batched_reset
from tests.torch_ref import jax_states, jit_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

# the sizes of tests/test_pallas_update.py:178
T, N, L, RB, HID = 4, 3, 23, 4, 32
B = RB * LANE
DIMS = BlockDims(L, HID, HID, 5)
KW = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01)
GRAD_FRAC = 0.06
METRIC_TOL = dict(rtol=3e-2, atol=3e-3)


def stacked_flax_params(seed, n, obs_len, hidden, bias_noise=0.1):
    """N independent flax inits stacked on a leading agent axis (``init_seac``),
    biases moved off zero."""
    model = FlaxActorCritic(n_actions=5, hidden=hidden)
    params = jax.vmap(lambda k: model.init(k, jnp.zeros((1, obs_len))))(
        jax.random.split(jax.random.key(seed), n))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + bias_noise * rng.standard_normal(x.shape).astype(
            np.float32) if path[-1].key == "bias" else np.asarray(x), params)


def make_seac_batch(seed):
    """(obs (T, B, N, L), action, behaviour logp (T, B, N), old value,
    advantage, target (N_i, T, B, N_j)) as numpy."""
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((T, B, N, L)).astype(np.float32),
        rng.integers(0, 5, (T, B, N)).astype(np.int32),
        (rng.standard_normal((T, B, N)) * 0.1 - 1.6).astype(np.float32),
        *(rng.standard_normal((N, T, B, N)).astype(np.float32) for _ in range(3)),
    )


def to_native(batch, rows):
    """The JAX kernel's layout of time rows ``rows``: obs (T, L, N, RB,
    LANE) bf16, action and logp (T, N, RB, LANE), the cross arrays (T, N_i,
    N_j, RB, LANE)."""
    obs, action, logp, *cross = batch
    t = len(rows)
    out = [jnp.asarray(obs[rows].reshape(t, RB, LANE, N, L).transpose(0, 4, 3, 1, 2),
                       jnp.bfloat16)]
    out += [jnp.asarray(x[rows].reshape(t, RB, LANE, N).transpose(0, 3, 1, 2))
            for x in (action, logp)]
    out += [jnp.asarray(x[:, rows].reshape(N, t, RB, LANE, N).transpose(1, 0, 4, 2, 3))
            for x in cross]
    return tuple(out)


def torch_batch(batch):
    obs, *rest = batch
    return (torch.from_numpy(obs).to(torch.bfloat16), *map(torch.from_numpy, rest))


@pytest.fixture(scope="module")
def case():
    params = stacked_flax_params(0, N, L, (HID, HID))
    return params, convert.seac_params_from_flax(params), make_seac_batch(1)


@pytest.mark.parametrize("t_mb,start,seac_lambda", [(T, 0, 1.0), (2, 3, 0.5), (2, 1, 1.0)])
def test_k8_plain_matches_pallas(case, t_mb, start, seac_lambda):
    """Every agent's gradients and the four metrics; (2, 3) is a window that
    wraps (rows 3 and 0), and seac_lambda 0.5 weighs the off-diagonal pairs."""
    params, theta, batch = case
    rows = [(start + t) % T for t in range(t_mb)]
    grads_fn = jax_grads(obs_len=L, hidden=(HID, HID), n_actions=5, rollout_len=t_mb,
                         n_agents=N, mb_rows=RB, seac_lambda=seac_lambda, interpret=True, **KW)
    jg, jm = jit_bf16_exact(grads_fn, params, to_native(batch, rows))
    k8 = build_fused_seac_grads(DIMS, N, t_mb, seac_lambda=seac_lambda, **KW)
    grads, sums = k8(theta, torch_batch(batch), start)
    assert k8.launches == 0  # CPU tensors take the plain version
    assert grads.shape == (N, DIMS.n_params)
    got = metric_means(sums, t_mb * B * N)
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(jm[k]), err_msg=k, **METRIC_TOL)
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jg))[0])
    flat = jax.tree_util.tree_flatten_with_path(convert.seac_params_to_flax(grads, DIMS))[0]
    assert len(flat) == len(want) == 8
    for path, g in flat:
        w = want[path]
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, atol=GRAD_FRAC * max(np.abs(w).max(), 1e-6),
                                   err_msg=str(path))


def test_k8_window_equals_sliced_copy(case):
    """A window read in place gives what its copied-out rows give, and the
    advantage statistics are over all pairs of the window."""
    _, theta, batch = case
    data = torch_batch(batch)
    k8 = build_fused_seac_grads(DIMS, N, 2, seac_lambda=0.7, **KW)
    rows = [3, 0]
    window = tuple(x[rows].contiguous() for x in data[:3]) + tuple(
        x[:, rows].contiguous() for x in data[3:])
    g1, s1 = k8(theta, data, 3)
    g2, s2 = k8(theta, window, 0)
    torch.testing.assert_close(g1, g2, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(s1, s2, rtol=1e-6, atol=1e-6)
    stats = window_advstats(data[4], 3, 2, time_dim=1)
    adv = data[4][:, rows]
    torch.testing.assert_close(stats, torch.stack([adv.mean(), 1 / (adv.std(correction=0) + 1e-8)]))


def test_k8_lambda_zero_isolates_agents(case):
    """With seac_lambda 0 agent i learns from its own samples alone: its
    gradient does not move when another agent's cross values change."""
    _, theta, batch = case
    data = torch_batch(batch)
    k8 = build_fused_seac_grads(DIMS, N, T, seac_lambda=0.0, **KW)
    stats = window_advstats(data[4], 0, T, time_dim=1)
    g1, _ = k8(theta, data, 0, stats)
    changed = list(data)
    for k in (3, 5):  # agent 0's critic on agent 1's samples
        changed[k] = data[k].clone()
        changed[k][0, :, :, 1] += 1.0
    g2, _ = k8(theta, tuple(changed), 0, stats)
    assert torch.equal(g1[1:], g2[1:])
    assert torch.equal(g1[0], g2[0])  # a pair of weight 0 takes no part at all
    g3, _ = build_fused_seac_grads(DIMS, N, T, seac_lambda=1.0, **KW)(theta, tuple(changed), 0,
                                                                       stats)
    g4, _ = build_fused_seac_grads(DIMS, N, T, seac_lambda=1.0, **KW)(theta, data, 0, stats)
    assert not torch.equal(g3[0], g4[0]) and torch.equal(g3[1:], g4[1:])


def test_k8_checks_inputs(case):
    _, theta, batch = case
    data = torch_batch(batch)
    k8 = build_fused_seac_grads(DIMS, N, 2, seac_lambda=1.0, **KW)
    with pytest.raises(ValueError, match="params must be"):
        k8(theta[:2], data, 0)
    with pytest.raises(ValueError, match="old value"):
        k8(theta, data[:3] + (data[3][:, :, :, :2].contiguous(),) + data[4:], 0)
    with pytest.raises(ValueError, match="obs must be"):
        k8(theta, (data[0].float(),) + data[1:], 0)
    with pytest.raises(ValueError, match="no fused SEAC gradient"):
        k8(theta.to("meta"), tuple(x.to("meta") for x in data), 0)


# ---------------------------------------------------------------------------
# K2d: the per-agent collector.
# ---------------------------------------------------------------------------

K2D_T = 8


@pytest.fixture(scope="module")
def collect_pair():
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", max_steps=6).config)
    length = env.config.flattened_obs_length
    params = stacked_flax_params(3, 2, length, (128, 128))
    jstates = jax_states(jenv, ENV_BLOCK, seed=2)
    jcollect = build_pallas_collect(jenv.config, K2D_T, tc_len=4, interpret=True,
                                    deterministic=True, policy="mlp_per_agent")
    jns, jtraj = jit_bf16_exact(lambda s, p: jcollect(s, p, 0), jstates,
                                jax.tree.map(jnp.asarray, params))
    policies = seac_policies_of(BlockDims(length, 128, 128, 5), convert.seac_params_from_flax(params))
    collect = build_fused_collect_per_agent(env.config, K2D_T, deterministic=True)
    ns, traj = collect(to_port(jstates), policies, 0)
    same = traj["action"].numpy() == np.asarray(jtraj["action"])
    return dict(jns=jns, jtraj=jtraj, ns=ns, traj=traj, same=same,
                env_ok=same.all(axis=(0, 2)), collect=collect, policies=policies)


def test_per_agent_actions_agree(collect_pair):
    assert collect_pair["collect"].launches == 0  # CPU tensors take the plain version
    assert collect_pair["same"].mean() >= 0.99
    assert collect_pair["env_ok"].mean() >= 0.98
    # the two agents run different networks: their deterministic actions differ
    a = collect_pair["traj"]["action"].numpy()
    assert (a[..., 0] != a[..., 1]).mean() > 0.05


def test_per_agent_trajectory_exact_where_actions_agree(collect_pair):
    traj, jtraj = collect_pair["traj"], collect_pair["jtraj"]
    same = collect_pair["same"].all(-1)  # (T, B)
    lockstep = np.concatenate([np.ones_like(same[:1]), np.cumprod(same, 0)[:-1]], 0) > 0
    np.testing.assert_array_equal(traj["obs"].float().numpy()[lockstep],
                                  np.asarray(jtraj["obs"], dtype=np.float32)[lockstep])
    ok = collect_pair["env_ok"]
    np.testing.assert_array_equal(traj["reward"].numpy()[:, ok], np.asarray(jtraj["reward"])[:, ok])
    np.testing.assert_array_equal(traj["done"].numpy()[:, ok],
                                  np.asarray(jtraj["done"]).astype(bool)[:, ok])
    assert int(traj["done"].sum()) == ENV_BLOCK  # every env ended one episode at step 6
    got = convert.state_to_numpy(collect_pair["ns"])
    for f in ("agent_x", "agent_y", "agent_dir", "agent_carrying", "shelf_x", "shelf_y",
              "cur_steps", "request_queue"):
        np.testing.assert_array_equal(got[f][ok], np.asarray(getattr(collect_pair["jns"], f))[ok],
                                      err_msg=f)


def test_per_agent_values_and_logp_close(collect_pair):
    ok, traj, jtraj = collect_pair["env_ok"], collect_pair["traj"], collect_pair["jtraj"]
    for k in ("value", "logp"):
        np.testing.assert_allclose(traj[k].numpy()[:, ok], np.asarray(jtraj[k])[:, ok], atol=2e-2,
                                   err_msg=k)


def test_per_agent_equals_shared_collector_when_agents_share():
    """N copies of one network give K2a's trajectory, draw for draw."""
    from rware_tpu_torch.ops.fused_rollout import build_fused_collect

    env = rware_tpu_torch.make("rware-small-4ag-v2", max_steps=10, device="cpu")
    states, _ = batched_reset(env, 0, 32)
    torch.manual_seed(0)
    policy = ActorCritic(env.config.flattened_obs_length)
    _, want = build_fused_collect(env.config, 12)(states, policy, 7)
    _, got = build_fused_collect_per_agent(env.config, 12)(states, [policy] * 4, 7)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_per_agent_collector_checks_and_routes():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu")
    states, _ = batched_reset(env, 0, 4)
    collect = build_fused_collect_per_agent(env.config, 2)
    length = env.config.flattened_obs_length
    with pytest.raises(ValueError, match="one per agent"):
        collect(states, [ActorCritic(length)], 0)
    with pytest.raises(ValueError, match="one per agent"):
        collect(states, [ActorCritic(length), ActorCritic(length, hidden=(64, 64))], 0)
    # all stacks in shared memory up to 3 agents at L=71; 4 or more agents
    # read their weights from device memory
    assert not collect.weights_global and collect.threads == 256
    for env_id in ("rware-small-4ag-v2", "rware-large-8ag-v2", "rware-tiny-16ag-v2"):
        big = build_fused_collect_per_agent(rware_tpu_torch.parse_env_id(env_id), 2)
        assert big.weights_global and big.threads == 256 and big.plan.rows == 128, env_id
    # read from device memory, the weights take no shared memory: the block
    # holds its 128 rows' observations under h1, then h2, and a record a row
    tiles = collect_plan(env.config, (128, 128), 2, weights_global=True)
    assert tiles.region("bm")[1] == 0 and tiles.region("h") == (0, 2 * 128 * 128)
    # three stacks fit beside a tile of 8 envs with its observation tile
    # beside the hidden one (the old footprint), four do not
    three = rware_tpu_torch.parse_env_id("rware-tiny-3ag-v2")
    assert not collect_plan(three, (128, 128), 3).weights_global
    assert collect_plan(rware_tpu_torch.parse_env_id("rware-tiny-4ag-v2"), (128, 128),
                        4).weights_global
