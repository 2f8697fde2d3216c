"""The port's CUDA kernels against their plain PyTorch versions on a GPU.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor the JAX package, so it also runs where only PyTorch
is installed; there the repository's ``tests/conftest.py`` (which sets up
JAX) is skipped::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""
import os

import numpy as np
import pytest
import torch

import rware_tpu_torch
from rware_tpu_torch.models import ActorCritic
from rware_tpu_torch.models import ippo, ippo_rnn, mappo, seac
from rware_tpu_torch.models.ippo_fused import phase_advstats, phase_window_starts
from rware_tpu_torch.ops.fused_mappo import (
    build_fused_critic_values,
    build_fused_mappo_grads,
    build_fused_mappo_update_phase,
)
from rware_tpu_torch.models.networks import (
    GruDims,
    init_actor_critic,
    init_recurrent_actor_critic,
)
from rware_tpu_torch.models.ppo import METRIC_KEYS, loss_grads
from rware_tpu_torch.ops.fused_gru import (
    GruSeqScan,
    build_fused_gru_loss_bwd,
    build_fused_gru_obs_bwd,
    build_fused_gru_obs_fwd,
    build_fused_gru_seq_bwd,
    build_fused_gru_seq_fwd,
    gru_obs_fwd_plan,
    gru_seq_fwd_plan,
)
from rware_tpu_torch.ops.fused_rollout import (
    build_fused_collect,
    build_fused_collect_gru,
    build_fused_collect_gru_per_agent,
    build_fused_collect_per_agent,
    build_fused_rollout,
    collect_plan,
)
from rware_tpu_torch.ops.fused_seac import build_fused_seac_grads
from rware_tpu_torch.ops.fused_update import (
    build_fused_ppo_grads,
    build_fused_ppo_update_phase,
)
from rware_tpu_torch.parallel import batched_reset
from rware_tpu_torch.testing import (
    random_gru_seq_case,
    random_mappo_case,
    random_ppo_case,
    random_seac_case,
)

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
    policy = ActorCritic(env.config.flattened_obs_length).to(DEV)
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


# The eight instantiations of csrc/fused_collect.cu (weights in device memory,
# message bits, image observations): K2a on tiny-2ag, with K2b (M=2), with
# K2e (img-tiny-2ag) and with both; K2d on tiny-2ag with its weights in
# shared and (forced) in device memory, each with K2b and K2e.
COLLECT_CASES = [
    ("mlp", "rware-tiny-2ag-v2", 0, False), ("mlp", "rware-tiny-2ag-v2", 2, False),
    ("mlp", "rware-img-tiny-2ag-v2", 0, False), ("mlp", "rware-img-tiny-2ag-v2", 2, False),
    ("per_agent", "rware-tiny-2ag-v2", 0, False), ("per_agent", "rware-tiny-2ag-v2", 0, True),
    ("per_agent", "rware-tiny-2ag-v2", 2, True), ("per_agent", "rware-img-tiny-2ag-v2", 0, True),
    ("per_agent", "rware-img-tiny-2ag-v2", 2, True),
]


@pytest.mark.parametrize("kind,env_id,m,weights_global", COLLECT_CASES)
@pytest.mark.parametrize("b", [1, 1000])
@pytest.mark.parametrize("hidden", [(128, 128), (24, 40)])
@pytest.mark.parametrize("deterministic", [True, False])
def test_fused_collect_instantiations_match_plain(kind, env_id, m, weights_global, b, hidden,
                                                  deterministic):
    """Every instantiation of the MLP collector against its plain version:
    obs, actions, bits, rewards, done and the final state exact (they feed
    back), value and logp within ATOL; two launches bit-equal.  Hidden (24,
    40) is a multiple of 8 but not of 16: fewer 8 x 8 jobs than threads."""
    env = rware_tpu_torch.make(env_id, device=DEV, max_steps=20, msg_bits=m)
    states, _ = batched_reset(env, 1, b)
    gen = torch.Generator().manual_seed(3)
    nets = torch.nn.ModuleList(
        init_actor_critic(env.config.policy_obs_length, 5, hidden, (3, i), m)
        for i in range(env.n_agents if kind == "per_agent" else 1))
    with torch.no_grad():  # nonzero biases: a zero bias hides where it is rounded
        for p in nets.parameters():
            if p.dim() == 1:
                p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    nets = nets.to(DEV)
    if kind == "per_agent":
        policy = nets
        collect = build_fused_collect_per_agent(env.config, 16, hidden, deterministic)
        collect.plan = collect_plan(env.config, hidden, env.n_agents, weights_global)
    else:
        policy = nets[0]
        collect = build_fused_collect(env.config, 16, hidden, deterministic)
    assert collect.weights_global == weights_global
    ks, ktraj = collect(states, policy, 2)
    ks2, ktraj2 = collect(states, policy, 2)
    ps, ptraj = collect.plain(states, policy, 2)
    assert collect.launches == 2
    for k in ktraj:
        assert torch.equal(ktraj[k], ktraj2[k]), k
    for k in ("obs", "action", "reward", "done") + (("bits",) if m else ()):
        assert torch.equal(ktraj[k], ptraj[k]), k
    for k in ("value", "logp"):
        assert float((ktraj[k] - ptraj[k]).abs().max()) <= ATOL, k
    for f in FIELDS + ("agent_message",):
        assert torch.equal(getattr(ks, f), getattr(ps, f)), f
        assert torch.equal(getattr(ks, f), getattr(ks2, f)), f


def _oversize_config():
    """A 64 x 128 grid (8,192 cells) with 64 shelves: no tile of 32 compact
    envs fits a block's shared memory, so K1 takes the scan route."""
    from rware_tpu_torch.config import WarehouseConfig

    grid = [["."] * 128 for _ in range(64)]
    for k in range(64):
        grid[8 + k % 32][40 + 48 * (k // 32)] = "x"
    grid[63][60] = grid[63][61] = "g"
    return WarehouseConfig(layout="\n".join("".join(row) for row in grid), n_agents=4,
                           request_queue_size=8, max_steps=40)


@pytest.mark.parametrize("env_id,route,m", [
    ("rware-tiny-2ag-v2", "shared", 2),
    ("rware-large-8ag-v2", "global", 2),
    ("rware-tiny-16ag-v2", "scan", 0),
    ("rware-4x5-4ag-v2", None, 2),  # 304 shelves: a uint16 map in shared memory
    ("oversize", None, 0),  # 8,192 cells: the scan route by the plan
    ("rware-tiny-16ag-v2", None, 2),  # the resolver on bitmasks for 16 agents
    ("rware-2x3-32ag-v2", None, 0),  # 32 agents: the resolver on local arrays
])
@pytest.mark.parametrize("scripted", [True, False])
def test_fused_rollout_routes_match_plain(env_id, route, m, scripted):
    """K1 on each route of its plan (ops/fused_rollout.rollout_plan), bit for
    bit against its plain version, messages included."""
    from rware_tpu_torch.core.env import Warehouse

    if env_id == "oversize":
        env = Warehouse(_oversize_config(), device=DEV)
    else:
        env = rware_tpu_torch.make(env_id, device=DEV, max_steps=40, msg_bits=m)
    states, _ = batched_reset(env, 4, 1000)
    roll = build_fused_rollout(env.config, 64, scripted=scripted)
    roll.route = route
    assert roll.plan(1000).route == route or route is None
    if env_id == "oversize":
        assert roll.plan(1000).route == "scan"
    actions = None
    if scripted:
        gen = torch.Generator(device=DEV).manual_seed(1)
        actions = torch.randint(0, 5, (64, 1000, env.n_agents, 1 + m), generator=gen,
                                device=DEV, dtype=torch.int32)
        actions[..., 1:] %= 2
        actions = actions if m else actions[..., 0]
    ks, kr, ke = roll(states, 3, actions)
    ps, pr, pe = roll.plain(states, 3, actions)
    assert roll.launches == 1
    for f in FIELDS + ("agent_message",):
        assert torch.equal(getattr(ks, f), getattr(ps, f)), f
    assert torch.equal(kr, pr) and torch.equal(ke, pe)


@pytest.mark.parametrize("t_len", [0, 1, 2])
@pytest.mark.parametrize("scripted", [True, False])
def test_fused_rollout_messages_of_the_last_step(t_len, scripted):
    """K1 writes the messages once, from the last step's bits (zero where it
    ended an episode; as they came in after no step): short launches from a
    state whose messages are set, with episodes ending every other step."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=DEV, max_steps=2, msg_bits=3)
    states, _ = batched_reset(env, 5, 500)
    states, _, _ = build_fused_rollout(env.config, 1).plain(states, 6)  # bits set, steps 1
    roll = build_fused_rollout(env.config, t_len, scripted=scripted)
    actions = None
    if scripted:
        gen = torch.Generator(device=DEV).manual_seed(2)
        actions = torch.randint(0, 5, (t_len, 500, 2, 4), generator=gen, device=DEV,
                                dtype=torch.int32)
    ks, kr, ke = roll(states, 7, actions)
    ps, pr, pe = roll.plain(states, 7, actions)
    for f in FIELDS + ("agent_message",):
        assert torch.equal(getattr(ks, f), getattr(ps, f)), f
    assert torch.equal(kr, pr) and torch.equal(ke, pe)


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


@pytest.mark.parametrize("env_id", ["rware-tiny-2ag-v2", "rware-3s-tiny-2ag-v2"])
def test_fused_ppo_grads_kernel_matches_plain(env_id):
    """K4: gradients within 1e-2 of each block's largest |plain value| on a
    window that wraps; two launches give the same bits."""
    dims, params, data = random_ppo_case(env_id, 1000, 8, device=DEV)
    k4 = build_fused_ppo_grads(dims, 4, clip_eps=0.2, vf_coef=0.5, ent_coef=0.01)
    kg, ks = k4(params, data, 7)
    kg2, ks2 = k4(params, data, 7)
    pg, ps = k4.plain(params, data, 7)
    assert k4.launches == 2
    assert torch.equal(kg, kg2) and torch.equal(ks, ks2)
    for g, p in zip(dims.split(kg), dims.split(pg)):
        assert float((g - p).abs().max()) <= 1e-2 * float(p.abs().max())
    torch.testing.assert_close(ks, ps, rtol=1e-3, atol=1e-2)


def test_fused_ppo_update_phase_kernel_matches_plain():
    """K3: E=2, M=2 passes; parameters within 0.05 * lr * P of the plain
    version, two launches bit-equal."""
    dims, params, data = random_ppo_case("rware-tiny-2ag-v2", 1024, 8, device=DEV)
    cfg = ippo.IPPOConfig(epochs=2, minibatches=2)
    k3 = build_fused_ppo_update_phase(dims, 8, 2, 2, clip_eps=0.2, vf_coef=0.5, ent_coef=0.01,
                                      max_grad_norm=0.5)
    starts = phase_window_starts(cfg, 8, k3.time_block, torch.Generator().manual_seed(0)).to(DEV)
    args = (params, torch.zeros_like(params), torch.zeros_like(params), data, starts,
            phase_advstats(data[4], starts, 4), ippo.adam_hyper(cfg, 0, 4).to(DEV))
    out = k3(*args)
    again = k3(*args)
    plain = k3.plain(*args)
    assert k3.launches == 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert float((out[0] - plain[0]).abs().max()) <= 0.05 * cfg.lr * 4
    assert float((out[0] - params).abs().max()) > 0


# tiny-16ag: the critic's dense_0 does not fit a block's shared memory
@pytest.mark.parametrize("env_id", ["rware-tiny-2ag-v2", "rware-tiny-16ag-v2"])
def test_fused_critic_values_kernel_matches_plain(env_id):
    """K6: a flipped bf16 rounding of a hidden unit is the largest allowed
    difference (2e-2, as for the collector's values), and rare (mean 1e-4)."""
    _, cdims, params, data = random_mappo_case(env_id, 1000, 8, device=DEV)
    k6 = build_fused_critic_values(cdims)
    kv = k6(params["critic"], data[0])
    pv = k6.plain(params["critic"], data[0])
    assert k6.launches == 1 and kv.shape == data[1].shape
    diff = (kv - pv).abs()
    assert float(diff.max()) <= ATOL and float(diff.mean()) <= 1e-4


@pytest.mark.parametrize("env_id", ["rware-tiny-2ag-v2", "rware-tiny-16ag-v2"])
def test_fused_mappo_grads_kernel_matches_plain(env_id):
    """K5, with and without the actor: gradients within 1e-2 of each block's
    largest |plain value| on a window that wraps; two launches give the same
    bits; the actor's local value head gets exactly zero."""
    dims, cdims, params, data = random_mappo_case(env_id, 1000, 8, device=DEV)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01)
    k5 = build_fused_mappo_grads(dims, cdims, 4, **kw)
    kg, ks = k5(params, data, 7)
    kg2, ks2 = k5(params, data, 7)
    pg, ps = k5.plain(params, data, 7)
    assert k5.launches == 2
    assert all(torch.equal(kg[k], kg2[k]) for k in kg) and torch.equal(ks, ks2)
    for part, d in (("actor", dims), ("critic", cdims)):
        for g, p in zip(d.split(kg[part]), d.split(pg[part])):
            assert float((g - p).abs().max()) <= 1e-2 * float(p.abs().max()) + 1e-12
    torch.testing.assert_close(ks, ps, rtol=1e-3, atol=1e-2)
    head = dims.split(kg["actor"])
    assert float(head[4][:, dims.n_actions].abs().max()) == 0.0
    assert float(head[5][0, dims.n_actions].abs()) == 0.0
    k5c = build_fused_mappo_grads(None, cdims, 4, with_actor=False, **kw)
    cg, cs = k5c(params["critic"], (data[0], data[3], data[5]), 7)
    assert k5c.launches == 1
    assert torch.equal(cg, kg["critic"]) and float(cs[0]) == float(cs[2]) == 0.0
    torch.testing.assert_close(cs[1], ps[1], rtol=1e-3, atol=1e-2)


def test_fused_mappo_update_phase_kernel_matches_plain():
    """K7: E=2, M=2 passes; both parts' parameters within 0.05 * lr * P of
    the plain version, two launches bit-equal."""
    dims, cdims, params, data = random_mappo_case("rware-tiny-2ag-v2", 1024, 8, device=DEV)
    cfg = ippo.IPPOConfig(epochs=2, minibatches=2)
    k7 = build_fused_mappo_update_phase(dims, cdims, 8, 2, 2, clip_eps=0.2, vf_coef=0.5,
                                        ent_coef=0.01, max_grad_norm=0.5)
    starts = phase_window_starts(cfg, 8, k7.time_block, torch.Generator().manual_seed(0)).to(DEV)
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    args = (params, zero, zero, data, starts, phase_advstats(data[4], starts, 4),
            ippo.adam_hyper(cfg, 0, 4).to(DEV))
    out = k7(*args)
    again = k7(*args)
    plain = k7.plain(*args)
    assert k7.launches == 2
    for part in ("actor", "critic"):
        assert all(torch.equal(a[part], b[part]) for a, b in zip(out[:3], again[:3]))
        assert float((out[0][part] - plain[0][part]).abs().max()) <= 0.05 * cfg.lr * 4
        assert float((out[0][part] - params[part]).abs().max()) > 0
    assert torch.equal(out[3], again[3])


# The recurrent collector's instantiations (message bits, image observations,
# one GRU or one an agent): K2c on tiny-2ag, with K2b (M=2), with K2e
# (img-tiny-2ag) and with both; K2d′ on tiny-2ag with its bias and head
# blocks in shared and (forced) in device memory, each with K2b and K2e.
GRU_COLLECT_CASES = [
    ("gru", "rware-tiny-2ag-v2", 0, None), ("gru", "rware-tiny-2ag-v2", 2, None),
    ("gru", "rware-img-tiny-2ag-v2", 0, None), ("gru", "rware-img-tiny-2ag-v2", 2, None),
    ("gru_per_agent", "rware-tiny-2ag-v2", 0, False),
    ("gru_per_agent", "rware-tiny-2ag-v2", 0, True),
    ("gru_per_agent", "rware-tiny-2ag-v2", 2, True),
    ("gru_per_agent", "rware-img-tiny-2ag-v2", 0, True),
    ("gru_per_agent", "rware-img-tiny-2ag-v2", 2, False),
]


@pytest.mark.parametrize("kind,env_id,m,heads_global", GRU_COLLECT_CASES)
@pytest.mark.parametrize("b", [1, 1000])
@pytest.mark.parametrize("hidden", [(128, 128), (24, 40)])
@pytest.mark.parametrize("deterministic", [True, False])
def test_fused_collect_gru_instantiations_match_plain(kind, env_id, m, heads_global, b, hidden,
                                                      deterministic):
    """Every instantiation of the recurrent collector against its plain
    version from a nonzero carry: obs, actions, bits, rewards, done, the
    final state and the new carry exact (they feed back), value and logp
    within ATOL; two launches bit-equal.  (E, Hg) = (24, 40) are multiples of
    8 but not of 16: fewer jobs than threads, one set of rows."""
    env = rware_tpu_torch.make(env_id, device=DEV, max_steps=20, msg_bits=m)
    states, _ = batched_reset(env, 1, b)
    n, length = env.n_agents, env.config.policy_obs_length
    gen = torch.Generator().manual_seed(3)
    nets = torch.nn.ModuleList(
        init_recurrent_actor_critic(length, 5, hidden[1], hidden[0], (3, i), m)
        for i in range(n if kind == "gru_per_agent" else 1))
    with torch.no_grad():  # nonzero biases: a zero bias hides where it is rounded
        for p in nets.parameters():
            if p.dim() == 1:
                p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    nets = nets.to(DEV)
    h0 = (torch.rand((b, n, hidden[1]), generator=gen) * 2 - 1).to(torch.bfloat16).to(DEV)
    if kind == "gru_per_agent":
        policy = nets
        collect = build_fused_collect_gru_per_agent(env.config, 16, hidden, deterministic)
        collect.heads_global = heads_global
    else:
        policy = nets[0]
        collect = build_fused_collect_gru(env.config, 16, hidden, deterministic)
    assert heads_global is None or collect.plan(b).heads_global == heads_global
    ks, kh, ktraj = collect(states, policy, 2, h0)
    ks2, kh2, ktraj2 = collect(states, policy, 2, h0)
    ps, ph, ptraj = collect.plain(states, policy, 2, h0)
    assert collect.launches == 2
    assert torch.equal(kh, kh2) and torch.equal(kh, ph)
    for k in ktraj:
        assert torch.equal(ktraj[k], ktraj2[k]), k
    for k in ("obs", "action", "reward", "done") + (("bits",) if m else ()):
        assert torch.equal(ktraj[k], ptraj[k]), k
    for k in ("value", "logp"):
        assert float((ktraj[k] - ptraj[k]).abs().max()) <= ATOL, k
    for f in FIELDS + ("agent_message",):
        assert torch.equal(getattr(ks, f), getattr(ps, f)), f
        assert torch.equal(getattr(ks, f), getattr(ks2, f)), f


def test_make_builds_on_the_card_by_default():
    assert rware_tpu_torch.make("rware-tiny-2ag-v2").device.type == "cuda"


@pytest.mark.parametrize("deterministic", [True, False])
def test_fused_collect_gru_kernel_matches_plain(deterministic):
    """K2c: obs, rewards, done and the final state exact (the recurrence feeds
    any difference back into later actions), values and logp within ATOL, the
    carry within one bf16 step."""
    env = rware_tpu_torch.make("rware-small-4ag-v2", device=DEV, max_steps=20)
    states, _ = batched_reset(env, 2, 1000)
    policy = init_recurrent_actor_critic(env.config.flattened_obs_length, 5, 128, 128, 1).to(DEV)
    gen = torch.Generator().manual_seed(0)
    h0 = (torch.rand((1000, 4, 128), generator=gen) * 2 - 1).to(torch.bfloat16).to(DEV)
    collect = build_fused_collect_gru(env.config, 32, deterministic=deterministic)
    ks, kh, ktraj = collect(states, policy, 3, h0)
    ps, ph, ptraj = collect.plain(states, policy, 3, h0)
    assert collect.launches == 1
    for k in ("obs", "reward", "done"):
        assert torch.equal(ktraj[k], ptraj[k]), k
    for f in FIELDS:
        assert torch.equal(getattr(ks, f), getattr(ps, f)), f
    assert float((ktraj["action"] == ptraj["action"]).float().mean()) >= 0.999
    for k in ("value", "logp"):
        assert float((ktraj[k] - ptraj[k]).abs().max()) <= ATOL, k
    assert float((kh.float() - ph.float()).abs().max()) <= 2.0 ** -7


def _gru_case(b, t_len, seed, length=71, n_agents=2):
    dims = GruDims(length, 128, 128, 5)
    gen = torch.Generator().manual_seed(seed)
    weights = [(torch.randn(s, generator=gen) * (0.1 if s[0] == 1 else s[0] ** -0.5)).to(DEV)
               for s in dims.shapes[:6]]
    obs = (torch.randint(0, 3, (t_len, b, n_agents, length), generator=gen) * 0.5)
    done = (torch.rand((t_len, b), generator=gen) < 0.2).to(DEV)
    h0 = (torch.rand((b, n_agents, 128), generator=gen) * 2 - 1).to(torch.bfloat16).to(DEV)
    return dims, weights, obs.to(torch.bfloat16).to(DEV), done, h0


@pytest.mark.parametrize("band", [(0, 600), (450, 300)])
def test_fused_gru_kernels_match_plain(band):
    """K9 within one bf16 step on 99.9% of the entries; K10 within 1e-2 of
    each block's largest |plain|, two launches bit-equal; a band that wraps."""
    dims, weights, obs, done, h0 = _gru_case(600, 8, 4)
    fwd, bwd = build_fused_gru_obs_fwd(dims), build_fused_gru_obs_bwd(dims)
    kh, ph = fwd(weights, obs, done, h0, *band), fwd.plain(weights, obs, done, h0, *band)
    assert fwd.launches == 1 and kh.shape == (8, band[1], 2, 128)
    diff = (kh.float() - ph.float()).abs()
    assert float((diff <= 2.0 ** -7).float().mean()) >= 0.999 and float(diff.max()) <= 2.0 ** -4
    dh = (torch.randn(ph.shape, generator=torch.Generator().manual_seed(1)) * 1e-3)
    dh = dh.to(torch.bfloat16).to(DEV)
    kg, kd = bwd(weights, obs, done, h0, ph, dh, *band)
    kg2, kd2 = bwd(weights, obs, done, h0, ph, dh, *band)
    pg, pd = bwd.plain(weights, obs, done, h0, ph, dh, *band)
    assert bwd.launches == 2 and torch.equal(kg, kg2) and torch.equal(kd, kd2)
    for g, w in zip(bwd.split(kg), bwd.split(pg)):
        assert float((g - w).abs().max()) <= 1e-2 * float(w.abs().max())
    assert float((kd - pd).abs().max()) <= 1e-2 * float(pd.abs().max())


@pytest.mark.parametrize("env_id,b,t_len,band,rows", [
    ("rware-tiny-16ag-v2", 4200, 4, (4000, 4096), 64),
    ("rware-3s-tiny-2ag-v2", 2400, 6, (2300, 2200), 32),
])
def test_fused_gru_fwd_matches_plain_on_many_blocks_and_long_obs(env_id, b, t_len, band, rows):
    """K9 at tiny-16ag on a 4,096-env band (1,024 blocks of 64 sequences) and
    at sensor range 3 (L=351: blocks of 32, the one-wave tile of 64 does not
    fit the shared memory), bands that wrap: within one bf16 step on 99.9% of
    the entries, none past 8 steps, two launches bit-equal."""
    cfg = rware_tpu_torch.parse_env_id(env_id)
    dims, weights, obs, done, h0 = _gru_case(b, t_len, 6, cfg.policy_obs_length, cfg.n_agents)
    plan = gru_obs_fwd_plan(dims, cfg.n_agents, band[1])
    assert plan.rows == rows
    fwd = build_fused_gru_obs_fwd(dims)
    kh, kh2 = fwd(weights, obs, done, h0, *band), fwd(weights, obs, done, h0, *band)
    ph = fwd.plain(weights, obs, done, h0, *band)
    assert fwd.launches == 2 and torch.equal(kh, kh2)
    diff = (kh.float() - ph.float()).abs()
    assert float((diff <= 2.0 ** -7).float().mean()) >= 0.999 and float(diff.max()) <= 2.0 ** -4


@pytest.mark.parametrize("widths,band", [((24, 40), (450, 300)), ((8, 8), (599, 2)),
                                         ((128, 128), (550, 100))])
def test_fused_gru_bwd_matches_plain_at_padded_widths(widths, band):
    """K10 at embed and hidden widths that are multiples of 8 but not of 16
    (its tensor-core tiles padded and masked) and on bands that wrap: within
    1e-2 of each block's largest |plain|, two launches bit-equal; the timed
    launch gives the same bits and a time for each of its four stages."""
    dims = GruDims(71, widths[0], widths[1], 5)
    gen = torch.Generator().manual_seed(5)
    weights = [(torch.randn(s, generator=gen) * (0.1 if s[0] == 1 else s[0] ** -0.5)).to(DEV)
               for s in dims.shapes[:6]]
    obs = (torch.randint(0, 3, (6, 600, 2, 71), generator=gen) * 0.5).to(torch.bfloat16).to(DEV)
    done = (torch.rand((6, 600), generator=gen) < 0.2).to(DEV)
    h0 = (torch.rand((600, 2, widths[1]), generator=gen) * 2 - 1).to(torch.bfloat16).to(DEV)
    fwd, bwd = build_fused_gru_obs_fwd(dims), build_fused_gru_obs_bwd(dims)
    ph = fwd.plain(weights, obs, done, h0, *band)
    dh = (torch.randn(ph.shape, generator=gen) * 1e-3).to(torch.bfloat16).to(DEV)
    kg, kd = bwd(weights, obs, done, h0, ph, dh, *band)
    kg2, kd2, ms = bwd.timed(weights, obs, done, h0, ph, dh, *band)
    pg, pd = bwd.plain(weights, obs, done, h0, ph, dh, *band)
    assert bwd.launches == 2 and torch.equal(kg, kg2) and torch.equal(kd, kd2)
    assert set(ms) == {"prologue", "sweep", "epilogue", "wgrad"} and min(ms.values()) > 0
    for g, w in zip(bwd.split(kg), bwd.split(pg)):
        assert float((g - w).abs().max()) <= 1e-2 * float(w.abs().max())
    assert float((kd - pd).abs().max()) <= 1e-2 * float(pd.abs().max())


@pytest.mark.parametrize("env_id,band", [("rware-tiny-2ag-v2", (0, 600)),
                                         ("rware-tiny-16ag-v2", (450, 300))])
def test_gru_seq_kernels_match_plain(env_id, band):
    """K11 within one bf16 step on 99.9% of the entries; K12 and K13 within
    1e-2 of each block's largest |plain|, K13's metric sums within rtol 1e-3
    of the means (and 1e-5: pg's is a mean of normalised advantages); two
    launches bit-equal; a band that wraps."""
    dims, a = random_gru_seq_case(env_id, 600, 8, band, 3, DEV)
    fwd, bwd = build_fused_gru_seq_fwd(dims), build_fused_gru_seq_bwd(dims)
    loss = build_fused_gru_loss_bwd(dims, 0.2, 0.5, 0.01)
    seq = (a["wh"], a["bhn"], a["iall"], a["done"], a["h0"])
    kh, kh2, ph = fwd(*seq, *band), fwd(*seq, *band), fwd.plain(*seq, *band)
    assert fwd.launches == 2 and torch.equal(kh, kh2) and kh.shape == ph.shape
    diff = (kh.float() - ph.float()).abs()
    assert float((diff <= 2.0 ** -7).float().mean()) >= 0.999 and float(diff.max()) <= 2.0 ** -4
    dh = (torch.randn(ph.shape, generator=torch.Generator().manual_seed(1)) * 1e-2)
    dh = dh.to(torch.bfloat16).to(DEV)
    k12, k12b, p12 = bwd(*seq, ph, dh, *band), bwd(*seq, ph, dh, *band), \
        bwd.plain(*seq, ph, dh, *band)
    largs = (a["wh"], a["bhn"], a["whead"], a["bhead"], *seq[2:], ph, a["action"], a["logp"],
             a["value"], a["adv"], a["target"], a["stats"], *band)
    k13, k13b, p13 = loss(*largs), loss(*largs), loss.plain(*largs)
    assert bwd.launches == loss.launches == 2
    for got, again, want in ((k12, k12b, p12), (k13[:6], k13b[:6], p13[:6])):
        for g, g2, w in zip(got, again, want):
            assert torch.equal(g, g2)
            assert float((g.float() - w.float()).abs().max()) <= 1e-2 * float(w.float().abs().max())
    n = float(ph[..., 0].numel())
    got, want = k13[6].double() / n, p13[6].double() / n
    assert bool(((got - want).abs() <= 1e-3 * want.abs() + 1e-5).all()), (got, want)


@pytest.mark.parametrize("env_id,band", [("rware-tiny-2ag-v2", (450, 300)),
                                         ("rware-tiny-16ag-v2", (550, 100))])
def test_gru_seq_backwards_match_plain_at_hidden_40(env_id, band):
    """K12 and K13 at embed 24 and hidden 40 (multiples of 8 but not of 16:
    their tensor-core tiles padded and masked) on bands that wrap: within 1e-2
    of each block's largest |plain|, K13's metric sums within rtol 1e-3 of the
    means (and 1e-5); a launch, a second one and a timed one bit-equal, the
    timed one with a time for each of its four kernels."""
    dims, a = random_gru_seq_case(env_id, 600, 8, band, 11, DEV, hidden=40, embed=24)
    fwd, bwd = build_fused_gru_seq_fwd(dims), build_fused_gru_seq_bwd(dims)
    loss = build_fused_gru_loss_bwd(dims, 0.2, 0.5, 0.01)
    seq = (a["wh"], a["bhn"], a["iall"], a["done"], a["h0"])
    ph = fwd.plain(*seq, *band)
    dh = (torch.randn(ph.shape, generator=torch.Generator().manual_seed(4)) * 1e-2)
    dh = dh.to(torch.bfloat16).to(DEV)
    largs = (a["wh"], a["bhn"], a["whead"], a["bhead"], *seq[2:], ph, a["action"], a["logp"],
             a["value"], a["adv"], a["target"], a["stats"], *band)
    for kernel, args in ((bwd, seq + (ph, dh) + band), (loss, largs)):
        got, again = kernel(*args), kernel(*args)
        (timed, ms), want = kernel.timed(*args), kernel.plain(*args)
        assert kernel.launches == 3
        assert set(ms) == {"prologue", "sweep", "wgrad", "reduce"} and min(ms.values()) > 0
        for g, g2, g3 in zip(got, again, timed):
            assert torch.equal(g, g2) and torch.equal(g, g3)
        for g, w in zip(got[:6], want[:6]):  # K13's metric sums below
            assert float((g.float() - w.float()).abs().max()) <= 1e-2 * float(w.float().abs().max())
    n = float(ph[..., 0].numel())
    got, want = got[6].double() / n, want[6].double() / n
    assert bool(((got - want).abs() <= 1e-3 * want.abs() + 1e-5).all()), (got, want)


@pytest.mark.parametrize("env_id,b,t_len,band,widths", [
    ("rware-tiny-16ag-v2", 16384, 4, (16384 - 5 * 128, 4096), (128, 128)),
    ("rware-tiny-2ag-v2", 600, 8, (450, 300), (24, 40)),
    ("rware-tiny-16ag-v2", 600, 8, (550, 100), (24, 40)),
    ("rware-tiny-2ag-v2", 600, 8, (599, 2), (8, 8)),
])
def test_gru_seq_fwd_matches_plain_at_many_blocks_and_padded_widths(env_id, b, t_len, band,
                                                                     widths):
    """K11 on tiny-16ag's 4,096-env band of B=16,384 that wraps (1,024 blocks
    of 64 sequences), and at hidden 40 and 8 (the tensor-core tiles padded,
    warps past the hidden idle) on bands that wrap: hseq within one bf16 step
    on 99.9% of the entries and 8 steps at most, two launches bit-equal."""
    dims, a = random_gru_seq_case(env_id, b, t_len, band, 7, DEV, hidden=widths[1],
                                  embed=widths[0])
    plan = gru_seq_fwd_plan(dims, a["h0"].shape[1], band[1])
    assert band[1] != 4096 or (plan.rows, plan.blocks) == (64, 1024)
    fwd = build_fused_gru_seq_fwd(dims)
    seq = (a["wh"], a["bhn"], a["iall"], a["done"], a["h0"])
    kh, kh2, ph = fwd(*seq, *band), fwd(*seq, *band), fwd.plain(*seq, *band)
    assert fwd.launches == 2 and torch.equal(kh, kh2) and kh.shape == ph.shape
    diff = (kh.float() - ph.float()).abs()
    assert float((diff <= 2.0 ** -7).float().mean()) >= 0.999 and float(diff.max()) <= 2.0 ** -4


def test_gru_seq_scan_on_the_card_matches_the_cpu():
    """GruSeqScan (K11 forward, K12 backward) under autograd on the card
    against the same call on the CPU (the plain versions), a band that
    wraps: hseq as above, the gradients of wh, bhn, iall and h0 within 1e-2
    of each one's largest |CPU|."""
    band = (450, 300)
    dims, a = random_gru_seq_case("rware-tiny-2ag-v2", 600, 8, band, 5, torch.device("cpu"))
    w = torch.randn((8, band[1], 2, dims.hidden), generator=torch.Generator().manual_seed(2))
    fwd, bwd = build_fused_gru_seq_fwd(dims), build_fused_gru_seq_bwd(dims)
    runs = []
    for dev in (DEV, torch.device("cpu")):
        leaves = [a[k].detach().to(dev).clone().requires_grad_(True)
                  for k in ("wh", "bhn", "iall", "h0")]
        hseq = GruSeqScan.apply(leaves[0], leaves[1], leaves[2], a["done"].to(dev), leaves[3],
                                *band, fwd, bwd)
        (hseq.float() * w.to(dev)).sum().backward()
        runs.append([hseq.detach().cpu()] + [x.grad.cpu() for x in leaves])
    assert fwd.launches == bwd.launches == 1
    (kh, *kg), (ph, *pg) = runs
    diff = (kh.float() - ph.float()).abs()
    assert float((diff <= 2.0 ** -7).float().mean()) >= 0.999 and float(diff.max()) <= 2.0 ** -4
    for g, want in zip(kg, pg):
        err = float((g.float() - want.float()).abs().max())
        assert err <= 1e-2 * float(want.float().abs().max())


def test_fused_loss_train_step_runs_on_the_card():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", max_steps=20)
    cfg = ippo.IPPOConfig(n_envs=1024, rollout_len=16, epochs=2, minibatches=2)
    runner, dims = ippo_rnn.init_rnn_runner(env, cfg, seed=0)
    step = ippo_rnn.build_rnn_fused_train_step(env, dims, cfg, fused_loss=True)
    new, metrics = step(runner)
    new, metrics = step(new)
    assert (step.collect.launches, step.seq_fwd.launches, step.loss_bwd.launches,
            step.gru_fwd.launches, step.gru_bwd.launches) == (2, 8, 8, 0, 0)
    assert new.params.device.type == "cuda" and float((new.params - runner.params).abs().max()) > 0
    assert int(metrics["episodes_done"]) == 1024
    for k, v in metrics.items():
        assert bool(torch.isfinite(v.float())), k


@pytest.mark.parametrize("m", [0, 2])
def test_rnn_mappo_train_step_runs_on_the_card(m):
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", max_steps=20, msg_bits=m)
    cfg = ippo.IPPOConfig(n_envs=1024, rollout_len=16, epochs=2, minibatches=2)
    runner, dims, cdims = mappo.init_rnn_mappo_runner(env, cfg, seed=0)
    step = mappo.build_rnn_mappo_train_step(env, dims, cdims, cfg)
    new, metrics = step(runner)
    new, metrics = step(new)
    assert (step.collect.launches, step.critic_values.launches, step.gru_fwd.launches,
            step.gru_bwd.launches, step.critic_grads.launches) == (2, 2, 8, 8, 8)
    for part in ("actor", "critic"):
        assert float((new.params[part] - runner.params[part]).abs().max()) > 0, part
    assert int(metrics["episodes_done"]) == 1024
    for k, v in metrics.items():
        assert bool(torch.isfinite(v.float())), k


def test_gru_kernels_reject_unsupported_widths():
    dims = GruDims(71, 128, 256, 5)
    weights = [torch.zeros(s, device=DEV) for s in dims.shapes[:6]]
    obs = torch.zeros((2, 8, 2, 71), dtype=torch.bfloat16, device=DEV)
    done = torch.zeros((2, 8), dtype=torch.bool, device=DEV)
    h0 = torch.zeros((8, 2, 256), dtype=torch.bfloat16, device=DEV)
    with pytest.raises(ValueError, match="multiples of 8 up to 128"):
        build_fused_gru_obs_fwd(dims)(weights, obs, done, h0, 0, 8)


def test_rnn_fused_train_step_runs_on_the_card():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", max_steps=20)
    cfg = ippo.IPPOConfig(n_envs=1024, rollout_len=16, epochs=2, minibatches=2)
    runner, dims = ippo_rnn.init_rnn_runner(env, cfg, seed=0)
    step = ippo_rnn.build_rnn_fused_train_step(env, dims, cfg)
    new, metrics = step(runner)
    new, metrics = step(new)
    assert (step.collect.launches, step.gru_fwd.launches, step.gru_bwd.launches) == (2, 8, 8)
    assert new.params.device.type == "cuda" and new.carry.dtype == torch.bfloat16
    assert float((new.params - runner.params).abs().max()) > 0
    assert int(metrics["episodes_done"]) == 1024
    for k, v in metrics.items():
        assert bool(torch.isfinite(v.float())), k


# tiny-2ag keeps both agents' weights in shared memory, large-8ag reads them
# from device memory
@pytest.mark.parametrize("env_id", ["rware-tiny-2ag-v2", "rware-large-8ag-v2"])
@pytest.mark.parametrize("deterministic", [True, False])
def test_fused_collect_per_agent_kernel_matches_plain(env_id, deterministic):
    """K2d: obs, actions, rewards, done and the final state exact, values and
    logp within ATOL."""
    env = rware_tpu_torch.make(env_id, device=DEV, max_steps=20)
    states, _ = batched_reset(env, 1, 1000)
    dims, params, _ = random_seac_case(env_id, 1, 1, seed=2)
    policies = seac.seac_policies_of(dims, params).to(DEV)
    collect = build_fused_collect_per_agent(env.config, 32, deterministic=deterministic)
    assert collect.weights_global == (env.n_agents > 3)
    ks, ktraj = collect(states, policies, 2)
    ps, ptraj = collect.plain(states, policies, 2)
    assert collect.launches == 1
    for k in ("obs", "action", "reward", "done"):
        assert torch.equal(ktraj[k], ptraj[k]), k
    for k in ("value", "logp"):
        assert float((ktraj[k] - ptraj[k]).abs().max()) <= ATOL, k
    for f in FIELDS:
        assert torch.equal(getattr(ks, f), getattr(ps, f)), f


@pytest.mark.parametrize("env_id,seac_lambda", [("rware-tiny-2ag-v2", 1.0),
                                                ("rware-small-4ag-v2", 0.5)])
def test_fused_seac_grads_kernel_matches_plain(env_id, seac_lambda):
    """K8: every agent's gradients within 1e-2 of each block's largest |plain
    value| on a window that wraps; two launches give the same bits."""
    dims, params, data = random_seac_case(env_id, 1000, 8, device=DEV)
    k8 = build_fused_seac_grads(dims, params.shape[0], 4, clip_eps=0.2, vf_coef=0.5,
                                ent_coef=0.01, seac_lambda=seac_lambda)
    kg, ks = k8(params, data, 7)
    kg2, ks2 = k8(params, data, 7)
    pg, ps = k8.plain(params, data, 7)
    assert k8.launches == 2 and kg.shape == params.shape
    assert torch.equal(kg, kg2) and torch.equal(ks, ks2)
    for i in range(params.shape[0]):
        for g, p in zip(dims.split(kg[i]), dims.split(pg[i])):
            assert float((g - p).abs().max()) <= 1e-2 * float(p.abs().max())
    torch.testing.assert_close(ks, ps, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("kernel", ["K4", "K5", "K6", "K8"])
def test_ppo_kernels_match_plain_at_padded_widths(kernel):
    """The PPO kernels at hidden (36, 20), multiples of 4 but not of 16: the
    tensor-core tiles padded with zeros, the stores masked.  Gradients within
    1e-2 of each block's largest |plain value| on a window that wraps, values
    as for K6 above; two launches give the same bits."""
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01)
    hidden = (36, 20)
    if kernel == "K8":
        dims, params, data = random_seac_case("rware-tiny-2ag-v2", 1000, 8, device=DEV,
                                              hidden=hidden)
        fn = build_fused_seac_grads(dims, params.shape[0], 4, seac_lambda=0.5, **kw)
        blocks = [(dims, lambda g, i=i: g[i]) for i in range(params.shape[0])]
    else:
        dims, cdims, both, data = random_mappo_case("rware-tiny-2ag-v2", 1000, 8, device=DEV,
                                                    hidden=hidden)
        if kernel == "K6":
            k6 = build_fused_critic_values(cdims)
            diff = (k6(both["critic"], data[0]) - k6.plain(both["critic"], data[0])).abs()
            assert float(diff.max()) <= ATOL and float(diff.mean()) <= 1e-4
            return
        if kernel == "K4":
            params, fn = both["actor"], build_fused_ppo_grads(dims, 4, **kw)
            blocks = [(dims, lambda g: g)]
        else:
            params, fn = both, build_fused_mappo_grads(dims, cdims, 4, **kw)
            blocks = [(dims, lambda g: g["actor"]), (cdims, lambda g: g["critic"])]
    kg, ks = fn(params, data, 7)
    kg2, ks2 = fn(params, data, 7)
    pg, ps = fn.plain(params, data, 7)
    assert fn.launches == 2 and torch.equal(ks, ks2)
    for d, part in blocks:
        assert torch.equal(part(kg), part(kg2))
        for g, p in zip(d.split(part(kg)), d.split(part(pg))):
            assert float((g - p).abs().max()) <= 1e-2 * float(p.abs().max()) + 1e-12
    torch.testing.assert_close(ks, ps, rtol=1e-3, atol=1e-2)


def test_seac_fused_train_step_runs_on_the_card():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", max_steps=20)
    cfg = seac.SEACPPOConfig(n_envs=1024, rollout_len=16, epochs=2, minibatches=2)
    runner, dims = seac.init_seac_ppo(env, cfg, seed=0)
    step = seac.build_seac_ppo_fused_train_step(env, dims, cfg)
    new, metrics = step(runner)
    new, metrics = step(new)
    assert (step.collect.launches, step.grads.launches) == (2, 8)
    assert new.params.device.type == "cuda" and new.params.shape == (2, dims.n_params)
    assert float((new.params - runner.params).abs().max()) > 0
    assert int(metrics["episodes_done"]) == 1024
    for k, v in metrics.items():
        assert bool(torch.isfinite(v.float())), k


# --- message bits: K1's message rows, K2b in both collectors, K4's message head ---

MSG_FIELDS = FIELDS + ("agent_message",)


@pytest.mark.parametrize("env_id,m", [("rware-tiny-2ag-v2", 2), ("rware-small-4ag-v2", 3)])
@pytest.mark.parametrize("scripted", [True, False])
def test_fused_rollout_message_rows_match_plain(env_id, m, scripted):
    env = rware_tpu_torch.make(env_id, device=DEV, max_steps=20, msg_bits=m)
    states, _ = batched_reset(env, 2, 1000)
    roll = build_fused_rollout(env.config, 32, scripted=scripted)
    actions = None
    if scripted:
        gen = torch.Generator(device=DEV).manual_seed(0)
        actions = torch.cat([
            torch.randint(0, 5, (32, 1000, env.n_agents, 1), generator=gen, device=DEV,
                          dtype=torch.int32),
            torch.randint(0, 2, (32, 1000, env.n_agents, m), generator=gen, device=DEV,
                          dtype=torch.int32)], dim=-1)
    ks, kr, ke = roll(states, 3, actions)
    ps, pr, pe = roll.plain(states, 3, actions)
    assert roll.launches == 1
    for f in MSG_FIELDS:
        assert torch.equal(getattr(ks, f), getattr(ps, f)), f
    assert torch.equal(kr, pr) and torch.equal(ke, pe)


@pytest.mark.parametrize("net", ["mlp", "gru"])
@pytest.mark.parametrize("deterministic", [True, False])
def test_fused_collect_message_mode_matches_plain(net, deterministic):
    """K2b: obs, actions, bits, rewards, done and the final state (messages
    included) exact; value and logp within 2e-2."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=DEV, max_steps=20, msg_bits=2)
    states, _ = batched_reset(env, 1, 1000)
    length = env.config.flattened_obs_length
    if net == "mlp":
        policy = ActorCritic(length, msg_bits=2).to(DEV)
        collect = build_fused_collect(env.config, 32, deterministic=deterministic)
        (ks, ktraj), (ps, ptraj) = (collect(states, policy, 2), collect.plain(states, policy, 2))
    else:
        policy = init_recurrent_actor_critic(length, 5, 128, 128, 0, msg_bits=2).to(DEV)
        collect = build_fused_collect_gru(env.config, 32, deterministic=deterministic)
        h0 = policy.initialize_carry((1000, 2))
        (ks, kh, ktraj), (ps, ph, ptraj) = (collect(states, policy, 2, h0),
                                            collect.plain(states, policy, 2, h0))
        assert torch.equal(kh, ph)
    assert collect.launches == 1
    for k in ("obs", "action", "bits", "reward", "done"):
        assert torch.equal(ktraj[k], ptraj[k]), k
    for k in ("value", "logp"):
        assert float((ktraj[k] - ptraj[k]).abs().max()) <= ATOL, k
    for f in MSG_FIELDS:
        assert torch.equal(getattr(ks, f), getattr(ps, f)), f


def test_fused_ppo_grads_message_head_matches_plain():
    """K4 with the message head (M=2): gradients within 1e-2 of each block's
    largest |plain value| on a window that wraps; two launches bit-equal."""
    dims, params, data = random_ppo_case("rware-tiny-2ag-v2", 1000, 8, device=DEV, msg_bits=2)
    k4 = build_fused_ppo_grads(dims, 4, clip_eps=0.2, vf_coef=0.5, ent_coef=0.01)
    kg, ks = k4(params, data, 7)
    kg2, ks2 = k4(params, data, 7)
    pg, ps = k4.plain(params, data, 7)
    assert k4.launches == 2
    assert torch.equal(kg, kg2) and torch.equal(ks, ks2)
    for g, p in zip(dims.split(kg), dims.split(pg)):
        assert float((g - p).abs().max()) <= 1e-2 * float(p.abs().max())
    torch.testing.assert_close(ks, ps, rtol=1e-3, atol=1e-2)


def test_message_learners_take_the_per_pass_kernels_on_the_card():
    """IPPO and MAPPO with message bits: K4 per pass, no K3, K5 or K7."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", max_steps=20, msg_bits=2)
    cfg = ippo.IPPOConfig(n_envs=1024, rollout_len=16, epochs=2, minibatches=2)
    from rware_tpu_torch.models import mappo
    from rware_tpu_torch.models.ippo_fused import build_fused_train_step

    runner, dims = ippo.init_runner(env, cfg, seed=0)
    step = build_fused_train_step(env, dims, cfg)
    new, metrics = step(runner)
    assert step.update_phase is None and (step.collect.launches, step.grads.launches) == (1, 4)
    assert float((new.params - runner.params).abs().max()) > 0
    runner, adims, cdims = mappo.init_mappo_runner(env, cfg, seed=0)
    step = mappo.build_mappo_train_step(env, adims, cdims, cfg)
    new, metrics = step(runner)
    assert (step.collect.launches, step.grads.actor.launches) == (1, 4)
    for k, v in metrics.items():
        assert bool(torch.isfinite(v.float())), k


# --- SEAC-PPO with message bits and recurrent SEAC-PPO: K2d with K2b, K2d′ ---


@pytest.mark.parametrize("env_id", ["rware-tiny-2ag-v2", "rware-large-8ag-v2"])
@pytest.mark.parametrize("m", [0, 2])
@pytest.mark.parametrize("heads_in_smem", [True, False])
def test_fused_collect_gru_per_agent_kernel_matches_plain(env_id, m, heads_in_smem):
    """K2d′ (and its message mode): obs, actions, bits, rewards, done, the
    final state and the new carry exact from a nonzero carry, value and logp
    within ATOL; the agents' bias and head blocks in shared or (forced)
    device memory."""
    env = rware_tpu_torch.make(env_id, device=DEV, max_steps=20, msg_bits=m)
    states, _ = batched_reset(env, 1, 1000)
    length, n = env.config.flattened_obs_length, env.n_agents
    gen = torch.Generator().manual_seed(3)
    policies = torch.nn.ModuleList(
        init_recurrent_actor_critic(length, 5, 128, 128, (3, i), m) for i in range(n))
    with torch.no_grad():
        for p in policies.parameters():
            if p.dim() == 1:
                p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    policies = policies.to(DEV)
    h0 = (torch.rand((1000, n, 128), generator=gen) * 2 - 1).to(torch.bfloat16).to(DEV)
    collect = build_fused_collect_gru_per_agent(env.config, 32, deterministic=False)
    collect.heads_global = not heads_in_smem
    assert collect.plan(1000).heads_global == (not heads_in_smem)
    ks, kh, ktraj = collect(states, policies, 2, h0)
    ps, ph, ptraj = collect.plain(states, policies, 2, h0)
    assert collect.launches == 1 and torch.equal(kh, ph)
    for k in ("obs", "action", "reward", "done") + (("bits",) if m else ()):
        assert torch.equal(ktraj[k], ptraj[k]), k
    for k in ("value", "logp"):
        assert float((ktraj[k] - ptraj[k]).abs().max()) <= ATOL, k
    for f in MSG_FIELDS:
        assert torch.equal(getattr(ks, f), getattr(ps, f)), f


@pytest.mark.parametrize("env_id", ["rware-tiny-2ag-v2", "rware-large-8ag-v2"])
def test_fused_collect_per_agent_message_mode_matches_plain(env_id):
    """K2d with K2b (M=2): every agent's stack in shared memory (tiny-2ag)
    or its dense layers in device memory (large-8ag); obs, actions, bits,
    rewards, done and the final state exact."""
    env = rware_tpu_torch.make(env_id, device=DEV, max_steps=20, msg_bits=2)
    states, _ = batched_reset(env, 1, 1000)
    length = env.config.flattened_obs_length
    policies = torch.nn.ModuleList(
        ActorCritic(length, msg_bits=2) for _ in range(env.n_agents)).to(DEV)
    collect = build_fused_collect_per_agent(env.config, 32)
    assert collect.weights_global == (env.n_agents > 3)
    ks, ktraj = collect(states, policies, 2)
    ps, ptraj = collect.plain(states, policies, 2)
    assert collect.launches == 1
    for k in ("obs", "action", "bits", "reward", "done"):
        assert torch.equal(ktraj[k], ptraj[k]), k
    for k in ("value", "logp"):
        assert float((ktraj[k] - ptraj[k]).abs().max()) <= ATOL, k
    for f in MSG_FIELDS:
        assert torch.equal(getattr(ks, f), getattr(ps, f)), f


def test_new_collectors_raise_rather_than_fall_back():
    """On CUDA tensors the per-agent collectors launch their kernels and never
    their plain versions, and refuse what the kernels cannot take."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=DEV, msg_bits=1)
    states, _ = batched_reset(env, 0, 64)
    length = env.config.flattened_obs_length
    gru = build_fused_collect_gru_per_agent(env.config, 4)
    mlp = build_fused_collect_per_agent(env.config, 4)
    for wrapper in (gru, mlp):
        wrapper.plain = lambda *args: pytest.fail("a CUDA tensor took the plain version")
    nets = torch.nn.ModuleList(init_recurrent_actor_critic(length, 5, 128, 128, i, 1)
                               for i in range(2)).to(DEV)
    h0 = torch.zeros((64, 2, 128), dtype=torch.bfloat16, device=DEV)
    gru(states, nets, 0, h0)
    mlp(states, torch.nn.ModuleList(ActorCritic(length, msg_bits=1) for _ in range(2)).to(DEV), 0)
    assert gru.launches == mlp.launches == 1
    with pytest.raises(ValueError, match="h0 must be bf16"):
        gru(states, nets, 0, h0.cpu())
    with pytest.raises(ValueError, match="multiples of 8"):
        build_fused_collect_gru_per_agent(env.config, 4, (12, 128))


@pytest.mark.parametrize("m", [0, 2])
def test_seac_gru_train_step_runs_on_the_card(m):
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", max_steps=20, msg_bits=m)
    cfg = seac.SEACPPOConfig(n_envs=1024, rollout_len=16, epochs=2, minibatches=2)
    runner, dims = seac.init_seac_gru(env, cfg, seed=0)
    step = seac.build_seac_gru_train_step(env, dims, cfg)
    step.collect.plain = lambda *args: pytest.fail("the learner took the plain collector")
    new, metrics = step(runner)
    new, metrics = step(new)
    assert step.collect.launches == 2 and not step.remat
    assert new.params.device.type == "cuda" and new.params.shape == (2, dims.n_params)
    assert float((new.params - runner.params).abs().max()) > 0
    assert new.carry.device.type == "cuda" and int(metrics["episodes_done"]) == 1024
    for k, v in metrics.items():
        assert bool(torch.isfinite(v.float())), k


def test_seac_message_learner_takes_k2d_on_the_card():
    """SEAC-PPO with message bits: K2d with K2b collect and the flat update
    (K8 has no message head)."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", max_steps=20, msg_bits=2)
    cfg = seac.SEACPPOConfig(n_envs=1024, rollout_len=16, epochs=2, minibatches=2)
    runner, dims = seac.init_seac_ppo(env, cfg, seed=0)
    step = seac.build_seac_ppo_train_step(env, dims, cfg)
    step.collect.plain = lambda *args: pytest.fail("the learner took the plain collector")
    new, metrics = step(runner)
    assert step.collect.launches == 1
    assert float((new.params - runner.params).abs().max()) > 0
    for k, v in metrics.items():
        assert bool(torch.isfinite(v.float())), k


# The torch-op half of the SEAC learners with message bits or GRUs on the card
# against the same call on the CPU, which tests/test_torch_seac_gru.py and
# tests/test_torch_seac.py hold to JAX, with their bounds: heads and values
# within 2e-2, loss metrics within rtol 2e-2, atol 2e-3, gradients within 5% of
# each block's largest |value|.  The replay's last carries are held within one
# bf16 step; over 128 steps each flipped rounding feeds the steps after it, so
# more entries differ than at the CPU tests' 8 steps (the CPU against JAX on
# this band: 1.0-1.3% of them), and the card's tanh and exp round otherwise
# than the CPU's: at most 5%.
SEAC_METRIC_TOL = dict(rtol=2e-2, atol=2e-3)
SEAC_GRAD_TOL = 0.05


@pytest.fixture
def all_cpu_threads():
    """The CPU references at full width take every core."""
    torch.set_num_threads(os.cpu_count())
    yield
    torch.set_num_threads(1)


def seac_loss_inputs(rng, lead, n, obs_len, msg_bits):
    """obs in {0, 0.5, 1} (lead..., N, L), random actions, behaviour logp
    (lead..., N), old values, advantages and targets (lead..., N, N), bits
    (lead..., N, M)."""
    obs = torch.from_numpy((rng.integers(0, 3, lead + (n, obs_len)) * 0.5).astype(np.float32))
    action = torch.from_numpy(rng.integers(0, 5, lead + (n,)))
    logp = torch.from_numpy((rng.standard_normal(lead + (n,)) * 0.1 - 1.6 - 0.7 * msg_bits)
                            .astype(np.float32))
    cross = tuple(torch.from_numpy(rng.standard_normal(lead + (n, n)).astype(np.float32))
                  for _ in range(3))
    bits = torch.from_numpy(rng.integers(0, 2, lead + (n, msg_bits)))
    return obs, action, logp, cross, bits


def assert_loss_grads_close(dims, cfg, loss, params, batch):
    """``loss``'s metrics and gradient on the card against the CPU's."""
    grads, metrics = loss_grads(lambda p: loss(cfg, dims, p, batch), params)
    cuda_batch = tuple(x.to(DEV) for x in batch)
    cgrads, cmetrics = loss_grads(lambda p: loss(cfg, dims, p, cuda_batch), params.to(DEV))
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(cmetrics[k]), float(metrics[k]), err_msg=k,
                                   **SEAC_METRIC_TOL)
    worst = 0.0
    for i in range(params.shape[0]):
        for j, (g, w) in enumerate(zip(dims.split(cgrads[i].cpu()), dims.split(grads[i]))):
            frac = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-6)
            assert frac <= SEAC_GRAD_TOL, (i, j, frac)
            worst = max(worst, frac)
    print(f"{loss.__name__} M={dims.msg_bits}: largest gradient difference {worst:.3g} "
          f"of its block's largest |value|")


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("m", [0, 2])
def test_seac_gru_torch_ops_on_the_card_match_the_cpu(m, reduced, all_cpu_threads):
    """``gru_cross_replay`` and ``seac_gru_loss`` on one env band of phase
    22's shape (B=4,096 / 4 bands = 1,024 envs, T=128, embed and GRU 128,
    tiny-2ag, episode ends inside the band, a nonzero carry): on the card
    the products run through cuBLAS, with PyTorch's default reduced-precision
    bf16 reductions allowed and without them, on the CPU through another
    summation order."""
    flags = torch.backends.cuda.matmul
    default, flags.allow_bf16_reduced_precision_reduction = \
        flags.allow_bf16_reduced_precision_reduction, reduced
    try:
        check_seac_gru_torch_ops(m, reduced)
    finally:
        flags.allow_bf16_reduced_precision_reduction = default


def check_seac_gru_torch_ops(m, reduced):
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu", msg_bits=m)
    runner, dims = seac.init_seac_gru(env, seac.SEACPPOConfig(n_envs=8), seed=3)
    rng = np.random.default_rng(4)
    t, b, n = 128, 1024, env.n_agents
    obs, action, logp, cross, bits = seac_loss_inputs(rng, (t, b), n, dims.obs_len, m)
    done = torch.from_numpy(rng.random((t, b)) < 1 / 64)
    h0 = torch.from_numpy(rng.uniform(-1, 1, (b, n, dims.hidden))).to(torch.bfloat16)
    params = runner.params
    with torch.no_grad():
        want = seac.gru_cross_replay(dims, params, obs, done, h0)
        got = seac.gru_cross_replay(dims, params.to(DEV), obs.to(DEV), done.to(DEV),
                                    h0.to(DEV))
    # heads: the logits, and with message bits the message logits
    pairs = list(zip(got[0], want[0])) if m else [(got[0], want[0])]
    errs = [float((g.cpu() - w).abs().max()) for g, w in pairs + [(got[1], want[1])]]
    diff = (got[2].cpu().float() - want[2].float()).abs()
    share = float((diff > 0).float().mean())
    print(f"cross replay M={m}, reduced-precision reductions {reduced}: heads and values "
          f"max_abs_err {errs}, last carry max {float(diff.max()):.3g} on {share:.4g} of the "
          "entries")
    assert max(errs) <= 2e-2, errs
    assert float(diff.max()) <= 2.0 ** -7 + 1e-6 and share <= 5e-2, (float(diff.max()), share)
    batch = (obs, done, action, logp, *cross, h0) + ((bits,) if m else ())
    assert_loss_grads_close(dims, seac.SEACPPOConfig(), seac.seac_gru_loss, params, batch)


def test_seac_flat_loss_with_bits_on_the_card_matches_the_cpu(all_cpu_threads):
    """``seac_ppo_loss`` with two message bits (the joint log-prob and
    entropy) at phase 23's widths (hidden (128, 128), tiny-2ag) on 32,768
    rows of bf16 observations, as the flat learner hands it a minibatch."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu", msg_bits=2)
    runner, dims = seac.init_seac_ppo(env, seac.SEACPPOConfig(n_envs=8), seed=5)
    rng = np.random.default_rng(6)
    obs, action, logp, cross, bits = seac_loss_inputs(rng, (32768,), env.n_agents,
                                                      dims.obs_len, 2)
    batch = (obs.to(torch.bfloat16), action, logp, *cross, bits)
    assert_loss_grads_close(dims, seac.SEACPPOConfig(), seac.seac_ppo_loss, runner.params, batch)


def image_policy(kind, config, seed):
    """A network (or one per agent) of ``kind`` at ``config``'s policy
    observation length, biases off zero."""
    gen = torch.Generator().manual_seed(seed)
    length, n, m = config.policy_obs_length, config.n_agents, config.msg_bits
    recurrent = kind.startswith("gru")

    def one(i):
        if recurrent:
            return init_recurrent_actor_critic(length, 5, 128, 128, (seed, i), m)
        return ActorCritic(length, msg_bits=m)

    nets = torch.nn.ModuleList(one(i) for i in range(n if kind.endswith("per_agent") else 1))
    with torch.no_grad():
        for p in nets.parameters():
            if p.dim() == 1:
                p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    nets = nets.to(DEV)
    return nets if kind.endswith("per_agent") else nets[0]


@pytest.mark.parametrize("kind,env_id,m", [
    ("mlp", "rware-img-tiny-2ag-v2", 0), ("mlp", "rware-imgdict-tiny-2ag-v2", 2),
    ("mlp", "rware-img-Nd-tiny-2ag-v2", 0), ("gru", "rware-img-tiny-2ag-v2", 0),
    ("gru", "rware-imgdict-tiny-2ag-v2", 2), ("mlp_per_agent", "rware-img-tiny-2ag-v2", 0),
    ("mlp_per_agent", "rware-img-large-8ag-v2", 0),
    ("gru_per_agent", "rware-img-Nd-small-4ag-v2", 2)])
@pytest.mark.parametrize("deterministic", [True, False])
def test_image_collectors_match_plain(kind, env_id, m, deterministic):
    """K2e in the four collectors: obs, rewards, done, bits, actions, the
    final state and the carry exact, value and logp within 2e-2."""
    build = {"mlp": build_fused_collect, "gru": build_fused_collect_gru,
             "mlp_per_agent": build_fused_collect_per_agent,
             "gru_per_agent": build_fused_collect_gru_per_agent}[kind]
    env = rware_tpu_torch.make(env_id, device=DEV, max_steps=20, msg_bits=m)
    states, _ = batched_reset(env, 1, 1000)
    policy = image_policy(kind, env.config, 3)
    collect = build(env.config, 32, deterministic=deterministic)
    args = (states, policy, 2)
    if kind.startswith("gru"):
        gen = torch.Generator().manual_seed(4)
        h0 = (torch.rand((1000, env.n_agents, 128), generator=gen) * 2 - 1).to(torch.bfloat16)
        args += (h0.to(DEV),)
    *kstate, ktraj = collect(*args)
    *pstate, ptraj = collect.plain(*args)
    assert collect.launches == 1
    assert ktraj["obs"].shape[-1] == env.config.policy_obs_length
    for k in ("obs", "action", "reward", "done") + (("bits",) if m else ()):
        assert torch.equal(ktraj[k], ptraj[k]), k
    for k in ("value", "logp"):
        assert float((ktraj[k] - ptraj[k]).abs().max()) <= ATOL, k
    for f in FIELDS:
        assert torch.equal(getattr(kstate[0], f), getattr(pstate[0], f)), f
    if kind.startswith("gru"):
        assert torch.equal(kstate[1], pstate[1])  # the carry
