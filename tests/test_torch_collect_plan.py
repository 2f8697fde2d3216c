"""The MLP collector's launch plan (``rware_tpu_torch/ops/fused_rollout.py::
collect_plan``) and the arithmetic premise of its kernel, on the CPU.

``csrc/fused_collect.cu`` (K2a, K2d and their message and image modes) runs
its hidden layers as FMA chains over bf16 operands and its f32 heads as
separately rounded multiplies and adds.  The premise: a product of two bf16
values is exact in float32, so one rounding of ``acc + x * w`` (an FMA) is
the two roundings of ``ordered_linear``; with f32 head weights it is not.

The plan: for B = 1, 1,000 and 16,384 its tiles cover each env once and each
(env, agent) row once, 8-row groups within one agent where every agent has
its own stack; its regions hold what the kernel keeps there within the
232,448 bytes a block may take; h1 goes over the observation tile and h2
over h1 only where every 8 x 8 job of the layer has a thread of its own; a
chunked observation tile holds whole 16-byte runs of features beside h1, every
job of dense_0 a thread of its own.  Over every id ``register_all`` registers (images
included) with 0 and 2 message bits, one stack and N, at hidden (128, 128),
it admits and routes exactly as the one-thread-per-env kernel's rule did
(copied below as ``old_rule``); at other widths it admits what that rule
admitted.  What that rule refused, sensor range 5 among them, the shared
network now takes with its weights in device memory, and K2d at many agents
with its observation tile in chunks (``tests/test_torch_collect_long_obs.py``
sweeps every sensor range).  The main shape runs two blocks an SM.
"""
import dataclasses

import numpy as np
import pytest
import torch

from rware_tpu_torch.models.networks import ordered_linear
from rware_tpu_torch.ops.fused_rollout import (
    COLLECT_REGIONS,
    SMEM_LIMIT,
    build_fused_collect,
    build_fused_collect_per_agent,
    collect_plan,
)
from rware_tpu_torch.registry import SIZES, parse_env_id

torch.set_num_threads(1)

PREFIXES = ("rware", "rware-img", "rware-imgdict", "rware-img-Nd", "rware-imgdict-Nd")


def bf16_values(rng, shape, lo=-20, hi=2):
    """bf16-exact float32 values, signs mixed, exponents spread over 2^lo to
    2^hi."""
    mant = rng.uniform(1.0, 2.0, shape) * rng.choice([-1.0, 1.0], shape)
    vals = (mant * np.exp2(rng.integers(lo, hi + 1, shape))).astype(np.float32)
    return torch.from_numpy(vals).to(torch.bfloat16).float().numpy()


def fma_chain(x, w, bias):
    """``x @ w.T + bias`` as the kernel sums it: k ascending, each step ``acc
    + x * w`` rounded to float32 once (float64 holds the product and the sum
    before that rounding: 53 >= 2 * 24 + 2 bits), then the bias added."""
    acc = np.zeros((x.shape[0], w.shape[0]), dtype=np.float32)
    for k in range(x.shape[1]):
        acc = (acc.astype(np.float64)
               + x[:, k:k + 1].astype(np.float64) * w[:, k].astype(np.float64)).astype(np.float32)
    return acc + bias


@pytest.mark.parametrize("k_in,n_out", [(45, 128), (71, 128), (89, 128), (128, 128)])
def test_fma_chain_on_bf16_operands_equals_ordered_linear(k_in, n_out):
    rng = np.random.default_rng(k_in)
    x = bf16_values(rng, (64, k_in))
    w = bf16_values(rng, (n_out, k_in))
    bias = rng.normal(size=n_out).astype(np.float32)
    want = ordered_linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias))
    got = fma_chain(x, w, bias)
    assert np.array_equal(want.numpy().view(np.uint32), got.view(np.uint32))


def test_fma_chain_with_f32_head_weights_differs_from_ordered_linear():
    """The heads read bf16 h2 and f32 weights: their products are not exact,
    so the kernel keeps separate roundings there."""
    rng = np.random.default_rng(0)
    h2 = torch.from_numpy(np.tanh(rng.normal(size=(256, 128))).astype(np.float32))
    h2 = h2.to(torch.bfloat16).float().numpy()
    w = (rng.normal(size=(6, 128)) * 0.1).astype(np.float32)
    bias = np.zeros(6, dtype=np.float32)
    want = ordered_linear(torch.from_numpy(h2), torch.from_numpy(w), torch.from_numpy(bias))
    got = fma_chain(h2, w, bias)
    assert not np.array_equal(want.numpy().view(np.uint32), got.view(np.uint32))


def old_rule(length, hidden, n_agents, msg_bits, per_agent):
    """(admitted, weights in device memory) by the rule of the kernel before
    this plan: one thread an env, 128, 64 or 32 threads, each thread's
    observation and first hidden layer a column of the tiles."""
    h1, h2 = hidden

    def smem(threads, stacks):
        f32 = stacks * (h1 + h2 + (5 + 1 + msg_bits) * (h2 + 1))
        bf16 = stacks * (h1 * length + h2 * h1) + (length + h1) * threads
        return ((4 * f32 + 15) // 16) * 16 + 2 * bf16

    stacks = n_agents if per_agent else 1
    glob = per_agent and not any(smem(t, stacks) <= SMEM_LIMIT for t in (128, 64, 32))
    return any(smem(t, 0 if glob else stacks) <= SMEM_LIMIT for t in (128, 64, 32)), glob


def registered_configs(prefix):
    """The configs of ``register_all(image=True)``'s ids under ``prefix`` with
    0 and 2 message bits, one for each (observation length, agents, bits)."""
    seen = {}
    for size in SIZES:
        for n in range(1, 20):
            for diff in ("", "-easy", "-hard"):
                try:
                    cfg = parse_env_id(f"{prefix}-{size}-{n}ag{diff}-v2")
                except ValueError:  # a queue longer than the shelves
                    continue
                for m in (0, 2):
                    c = dataclasses.replace(cfg, msg_bits=m)
                    seen.setdefault((c.policy_obs_length, n, m), c)
    return list(seen.values())


def check_plan(plan, cfg, hidden, n_stacks):
    """The invariants the kernel's launch check (``collect_plan_ok``) and its
    indexing rely on."""
    n, m, length = cfg.n_agents, cfg.msg_bits, cfg.policy_obs_length
    h1, h2 = hidden
    ws = 0 if plan.weights_global else n_stacks
    need = dict(w0=ws * length * h1 * 2, w1=ws * h1 * h2 * 2, wp=ws * 5 * h2 * 4,
                wv=ws * h2 * 4, wm=ws * m * h2 * 4, b0=ws * h1 * 4, b1=ws * h2 * 4,
                bp=ws * 5 * 4, bv=ws * 4, bm=ws * m * 4, out=plan.rows * plan.hrs * 4,
                view=plan.te * plan.vs * 4, done=plan.te)
    jobs0, jobs1 = (plan.rows // 8) * (h1 // 8), (plan.rows // 8) * (h2 // 8)
    x_in_h = plan.region("x")[0] == plan.region("x")[1]  # the obs tile under h1
    h2_in_h = plan.region("h2")[0] == plan.region("h2")[1]  # h2 written over h1
    need["x"] = plan.kx * plan.rs * 2 if plan.kx else 0 if x_in_h else length * plan.rs * 2
    need["h"] = max(h1, length if x_in_h else 0, h2 if h2_in_h else 0) * plan.rs * 2
    need["h2"] = 0 if h2_in_h else h2 * plan.rs * 2
    assert plan.offsets[0] == 0 and len(plan.offsets) == len(COLLECT_REGIONS) + 1
    assert list(plan.offsets) == sorted(plan.offsets)  # no region overlaps the next
    for name in COLLECT_REGIONS:
        start, end = plan.region(name)
        assert start % 16 == 0 and end - start >= need[name], name
    assert plan.smem <= SMEM_LIMIT
    assert plan.rows % 8 == 0 and plan.rows >= n * plan.te and plan.rs >= plan.rows
    assert plan.hrs >= 5 + 1 + m  # logits, value, message logits; then action, logp, reward
    layout = cfg.compile_layout()  # agents (2 words), messages, queue, shelves
    assert plan.vs >= 2 * n + n * m + cfg.request_queue_size + layout.n_shelves
    # a thread a row, and more to store beside them
    assert plan.threads % 32 == 0 and plan.threads <= 512 and plan.threads >= plan.rows + 32
    # written over the tile it reads only with a thread for each 8 x 8 job
    assert (not x_in_h or plan.threads >= jobs0) and h2_in_h == (plan.threads >= jobs1)
    assert 0 < plan.carveout <= 100
    if n_stacks > 1:
        assert plan.te % 8 == 0
    if plan.kx:  # a chunk of whole 16-byte runs beside h1, the weights in device
        # memory, a thread for each job of dense_0 (its sums stay in registers)
        assert plan.kx % 8 == 0 and 0 < plan.kx < length and not x_in_h
        assert plan.weights_global and plan.threads >= jobs0


@pytest.mark.parametrize("prefix", PREFIXES)
def test_plan_admits_and_routes_the_registered_ids_as_before(prefix):
    configs = registered_configs(prefix)
    assert configs
    for cfg in configs:
        n = cfg.n_agents
        for n_stacks in sorted({1, n}):
            ok, glob = old_rule(cfg.policy_obs_length, (128, 128), n, cfg.msg_bits, n_stacks > 1)
            assert ok, cfg  # every registered id fits the kernel before
            plan = collect_plan(cfg, (128, 128), n_stacks)
            assert plan.weights_global == glob, (cfg.policy_obs_length, n, cfg.msg_bits)
            check_plan(plan, cfg, (128, 128), n_stacks)


@pytest.mark.parametrize("hidden", [(64, 64), (24, 40), (256, 128), (128, 256)])
def test_plan_admits_what_the_old_rule_admitted_at_other_widths(hidden):
    for prefix in ("rware", "rware-imgdict"):
        for cfg in registered_configs(prefix):
            n = cfg.n_agents
            for n_stacks in sorted({1, n}):
                if old_rule(cfg.policy_obs_length, hidden, n, cfg.msg_bits, n_stacks > 1)[0]:
                    check_plan(collect_plan(cfg, hidden, n_stacks), cfg, hidden, n_stacks)


@pytest.mark.parametrize("env_id", ["rware-5s-tiny-2ag-v2", "rware-img-5s-tiny-2ag-v2",
                                    "rware-imgdict-5s-tiny-2ag-v2", "rware-5s-tiny-4ag-v2"])
@pytest.mark.parametrize("m", [0, 2])
def test_plan_refuses_what_the_old_rule_refused(env_id, m):
    """The shared network's weights and a smallest tile do not fit a block:
    the shared-memory route still refuses, and the plan takes the
    device-memory weight route, the whole tile, two blocks an SM; the
    collector builds on it."""
    cfg = dataclasses.replace(parse_env_id(env_id), msg_bits=m)
    assert not old_rule(cfg.policy_obs_length, (128, 128), cfg.n_agents, m, False)[0]
    with pytest.raises(ValueError, match="observation too long"):
        collect_plan(cfg, (128, 128), weights_global=False)
    plan = collect_plan(cfg, (128, 128))
    assert plan.weights_global and plan.kx == 0 and plan.blocks_per_sm == 2
    check_plan(plan, cfg, (128, 128), 1)
    assert build_fused_collect(cfg, 2).plan == plan


# Past the registered ids (sensor range 1): nothing the old rule admitted is
# refused (K2d's smallest tile, 8 N rows, takes its observation in chunks where
# the whole tile does not fit); the shared network takes what it refused (its
# smallest tile plus the weights at sensor range 5, and 4 with two message
# bits) with its weights in device memory.
SWEEP_AGENTS = (1, 2, 3, 4, 8, 16, 19)
NARROWED = set()
WIDENED = ({(f"{prefix}-5s-tiny-{n}ag-v2", m, False) for prefix in ("rware", "rware-img",
                                                                    "rware-imgdict")
            for n in SWEEP_AGENTS for m in (0, 2)}
           | {(f"rware-4s-tiny-{n}ag-v2", 2, False) for n in SWEEP_AGENTS})


def test_plan_at_longer_sensor_ranges_admits_as_the_old_rule_with_stated_exceptions():
    narrowed, widened = set(), set()
    for sensor in (2, 3, 4, 5):
        for prefix in ("rware", "rware-img", "rware-imgdict"):
            for n in SWEEP_AGENTS:
                env_id = f"{prefix}-{sensor}s-tiny-{n}ag-v2"
                base = parse_env_id(env_id)
                for m in (0, 2):
                    cfg = dataclasses.replace(base, msg_bits=m)
                    for per_agent in sorted({False, n > 1}):
                        old = old_rule(cfg.policy_obs_length, (128, 128), n, m, per_agent)[0]
                        try:
                            plan = collect_plan(cfg, (128, 128), n if per_agent else 1)
                            check_plan(plan, cfg, (128, 128), n if per_agent else 1)
                            new = True
                        except ValueError:
                            new = False
                        if old and not new:
                            narrowed.add((env_id, m, per_agent))
                        if new and not old:
                            widened.add((env_id, m, per_agent))
    assert narrowed == NARROWED and widened == WIDENED


@pytest.mark.parametrize("b", [1, 1000, 16384])
@pytest.mark.parametrize("env_id,per_agent", [("rware-tiny-2ag-v2", False),
                                              ("rware-tiny-2ag-v2", True),
                                              ("rware-small-4ag-v2", True),
                                              ("rware-tiny-16ag-v2", False),
                                              ("rware-large-19ag-v2", True)])
def test_tiles_cover_each_env_and_row_once(b, env_id, per_agent):
    cfg = parse_env_id(env_id)
    n = cfg.n_agents
    plan = collect_plan(cfg, (128, 128), n if per_agent else 1)
    envs = np.zeros(b, dtype=np.int64)
    for blk in range(plan.blocks(b)):
        e0 = blk * plan.te
        valid = min(plan.te, b - e0)
        assert valid >= 1
        envs[e0:e0 + valid] += 1
        rows = np.zeros(plan.rows, dtype=np.int64)
        for i in range(n):
            for e in range(valid):
                r = i * plan.te + e
                rows[r] += 1
                if per_agent:
                    assert r // 8 * 8 // plan.te == i  # its 8-row group runs stack i
        assert rows.max() == 1
    assert (envs == 1).all()


def test_main_shape_runs_two_blocks_an_sm():
    """tiny-2ag, hidden (128, 128), B=16,384: 64 envs (128 rows) a block on
    256 threads, 256 blocks, two an SM, the weights in shared memory; so with
    two message bits and with images."""
    cfg = parse_env_id("rware-tiny-2ag-v2")
    for c in (cfg, dataclasses.replace(cfg, msg_bits=2), parse_env_id("rware-img-tiny-2ag-v2")):
        plan = collect_plan(c, (128, 128))
        assert (plan.te, plan.rows, plan.threads, plan.blocks(16384)) == (64, 128, 256, 256)
        assert plan.blocks_per_sm == 2 and not plan.weights_global
        assert plan.carveout <= 100


def test_wrappers_take_the_plan_and_a_forced_route():
    cfg = parse_env_id("rware-tiny-2ag-v2")
    collect = build_fused_collect(cfg, 4, hidden=(24, 40))
    assert collect.plan == collect_plan(cfg, (24, 40)) and not collect.weights_global
    assert collect.threads == collect.plan.threads
    per_agent = build_fused_collect_per_agent(cfg, 4)
    assert not per_agent.weights_global  # two stacks fit beside the tile
    forced = collect_plan(cfg, (128, 128), 2, weights_global=True)
    assert forced.weights_global and forced.region("w0") == (0, 0) and forced.te == 64
    big = build_fused_collect_per_agent(parse_env_id("rware-large-8ag-v2"), 4)
    assert big.weights_global and big.plan.te % 8 == 0
