"""The port's env sharding on the CPU: a shard of the env batch, launched
with its global ``env_offset``, equals those rows of the global launch bit
for bit (``batched_reset``, K1's plain version and the plain versions of
the collectors K2a, K2b, K2c, K2d and K2d′ in random mode), and the helpers
of ``parallel.sharding`` (``shard_env_batch``, ``replicate``, ``env_slice``,
the packed all-reduce of ``data_parallel`` and ``psum``) on an in-process
emulation of two ranks (``testing.emulate_mesh``)."""
import sys

import pytest
import torch

import rware_tpu_torch
from rware_tpu_torch.models.networks import (
    init_actor_critic,
    init_recurrent_actor_critic,
)
from rware_tpu_torch.ops.fused_rollout import (
    build_fused_collect,
    build_fused_collect_gru,
    build_fused_collect_gru_per_agent,
    build_fused_collect_per_agent,
    build_fused_rollout,
)
from rware_tpu_torch.parallel import batched_reset
from rware_tpu_torch.parallel.sharding import (
    Mesh,
    data_parallel,
    psum,
    replicate,
    shard_env_batch,
    tree_map,
)
from rware_tpu_torch.testing import emulate_mesh

torch.set_num_threads(1)

B, LO, T_LEN = 48, 16, 6  # the shard is rows [LO, B) of a batch of B


def rows(tree, lo, hi):
    return tree_map(lambda x: x[lo:hi], tree)


def assert_tree_equal(a, b):
    la, lb = [], []
    tree_map(la.append, a)
    tree_map(lb.append, b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("env_id", ["rware-tiny-2ag-v2", "rware-small-4ag-v2"])
def test_batched_reset_shard_equals_global_rows(env_id):
    env = rware_tpu_torch.make(env_id, device="cpu")
    states, obs = batched_reset(env, 7, B)
    part, pobs = batched_reset(env, 7, B - LO, env_offset=LO)
    assert_tree_equal(part, rows(states, LO, B))
    assert torch.equal(pobs, obs[LO:])
    assert not torch.equal(batched_reset(env, 7, B - LO)[1], pobs)  # the offset keys the draws


@pytest.mark.parametrize("msg_bits", [0, 2])
def test_k1_plain_shard_equals_global_rows(msg_bits):
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu", msg_bits=msg_bits,
                               max_steps=3)  # episodes end, so respawns draw too
    states, _ = batched_reset(env, 1, B)
    roll = build_fused_rollout(env.config, T_LEN)
    want = roll(states, 5)
    got = roll(rows(states, LO, B), 5, env_offset=LO)
    assert_tree_equal(got[0], rows(want[0], LO, B))
    assert torch.equal(got[1], want[1][LO:]) and torch.equal(got[2], want[2][LO:])
    assert int(want[2].sum()) > 0 and roll.launches == 0


def _collect_case(kind, env):
    n, l_obs, m = env.n_agents, env.config.policy_obs_length, env.config.msg_bits
    if kind in ("mlp", "mlp_per_agent"):
        nets = [init_actor_critic(l_obs, 5, (32, 32), (3, i), m) for i in range(n)]
        build = build_fused_collect if kind == "mlp" else build_fused_collect_per_agent
        return build(env.config, T_LEN, (32, 32)), nets[0] if kind == "mlp" else nets, None
    nets = [init_recurrent_actor_critic(l_obs, 5, 32, 32, (3, i), m) for i in range(n)]
    build = build_fused_collect_gru if kind == "gru" else build_fused_collect_gru_per_agent
    h0 = torch.randn((B, n, 32), generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    return build(env.config, T_LEN, (32, 32)), nets[0] if kind == "gru" else nets, h0


@pytest.mark.parametrize("kind", ["mlp", "mlp_per_agent", "gru", "gru_per_agent"])
@pytest.mark.parametrize("msg_bits", [0, 2])
def test_collectors_plain_shard_equals_global_rows(kind, msg_bits):
    """K2a, K2d, K2c and K2d′ (K2b with message bits) in random mode: the
    shard's trajectory, final states and carry are the global launch's rows."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu", msg_bits=msg_bits,
                               max_steps=4)
    states, _ = batched_reset(env, 1, B)
    collect, policy, h0 = _collect_case(kind, env)
    if h0 is None:
        want = collect(states, policy, 9)
        got = collect(rows(states, LO, B), policy, 9, env_offset=LO)
    else:
        want = collect(states, policy, 9, h0)
        got = collect(rows(states, LO, B), policy, 9, h0[LO:], env_offset=LO)
        assert torch.equal(got[1], want[1][LO:])
    assert_tree_equal(got[0], rows(want[0], LO, B))
    for k, v in want[-1].items():
        assert torch.equal(got[-1][k], v[:, LO:]), k
    assert collect.launches == 0


def test_env_offset_is_checked():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu")
    states, _ = batched_reset(env, 1, 4)
    with pytest.raises(ValueError, match="32-bit env word"):
        build_fused_rollout(env.config, 2)(states, 0, env_offset=2**32 - 2)
    with pytest.raises(ValueError, match="32-bit env word"):
        batched_reset(env, 1, 4, env_offset=-1)


def test_env_slice_and_shard_env_batch():
    mesh = Mesh(None, 1, 4, "cpu")
    assert mesh.env_slice(32) == slice(8, 16)
    assert mesh.n_local(32) == 8 and mesh.env_offset(32) == 8
    with pytest.raises(ValueError, match="not divisible by the world size 4"):
        mesh.env_slice(30)
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu")
    states, obs = batched_reset(env, 3, 32)
    part = shard_env_batch({"states": states, "obs": obs}, mesh)
    assert_tree_equal(part["states"], rows(states, 8, 16))
    assert torch.equal(part["obs"], obs[8:16])
    with pytest.raises(ValueError, match="rank 4 is not in a world of 4"):
        Mesh(None, 4, 4, "cpu")


def test_replicate_gives_rank_zeros_values():
    def fn(mesh):
        gen = torch.Generator().manual_seed(100 + mesh.rank)
        tree = {"p": torch.full((3,), float(mesh.rank)), "n": (torch.arange(2) + mesh.rank, 5),
                "gen": gen}
        out = replicate(tree, mesh)
        return out, torch.randint(0, 2**30, (4,), generator=out["gen"]), dict(mesh.counts)

    (a, ra, ca), (b, rb, cb) = emulate_mesh(fn, 2)
    assert torch.equal(a["p"], torch.zeros(3)) and torch.equal(b["p"], torch.zeros(3))
    assert torch.equal(b["n"][0], torch.arange(2)) and b["n"][1] == 5
    assert torch.equal(ra, rb)  # the generators continue alike
    assert ca == cb == {"all_reduce": 0, "broadcast": 3}


def test_data_parallel_is_one_packed_mean_and_psum_one_sum():
    def grads_fn(x, rank):
        return {"g": torch.tensor([1.0, 2.0]) * (rank + 1)}, torch.tensor([4.0 * rank])

    def fn(mesh):
        out = data_parallel(grads_fn, mesh)(None, mesh.rank)
        sums = psum((torch.tensor(0.5 * (mesh.rank + 1)), torch.tensor(3 + mesh.rank)), mesh)
        return out, sums, dict(mesh.counts)

    for out, sums, counts in emulate_mesh(fn, 2):
        assert torch.equal(out[0]["g"], torch.tensor([1.5, 3.0]))
        assert torch.equal(out[1], torch.tensor([2.0]))
        assert sums[0].dtype == torch.float32 and float(sums[0]) == 1.5
        assert sums[1].dtype == torch.int64 and int(sums[1]) == 7
        assert counts == {"all_reduce": 2, "broadcast": 0}
    assert data_parallel(grads_fn, None) is grads_fn


def test_emulated_collectives_under_thread_switches():
    """More ranks than cores and a thread switch every microsecond: every
    all-reduce of every rank sums every rank's deposit (a lost or early
    read would break the sums), and a rank that fails releases the rest."""
    world, rounds = 24, 40

    def fn(mesh):
        out = []
        for i in range(rounds):
            out.append(mesh.psum(torch.tensor([mesh.rank + i], dtype=torch.int64)))
        return torch.cat(out)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = emulate_mesh(fn, world, timeout=60)
    finally:
        sys.setswitchinterval(interval)
    want = torch.tensor([world * (world - 1) // 2 + world * i for i in range(rounds)])
    assert all(torch.equal(g, want) for g in got)

    def fails(mesh):
        if mesh.rank == 1:
            raise ValueError("rank 1 fails")
        return mesh.psum(torch.ones(1))

    with pytest.raises(ValueError, match="rank 1 fails"):
        emulate_mesh(fails, 3, timeout=60)
