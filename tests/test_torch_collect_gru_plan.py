"""The recurrent collector's launch plan (``rware_tpu_torch/ops/fused_rollout.py::
collect_gru_plan``) and the arithmetic premise of its kernel, on the CPU.

``csrc/collect_gru.cuh`` (K2c, K2d′ and their message and image modes) runs
the embed and both gate products as FMA chains over bf16 operands, each of
a thread's 4-row x 8-unit tiles gate by gate with ``gi = e Wi`` and ``gh = h
Wh`` summed from zero and joined in f32, and its f32 heads as separately
rounded multiplies and adds.  The premise: a product of two bf16 values is
exact in float32, so one rounding of ``acc + a * b`` (an FMA) is the two
roundings of ``ordered_matmul``; a cell built from such chains, with the
kernel's epilogue, gives ``gru_collect_step``'s new h, logits and value bit
for bit; with f32 head weights the chain differs; per-agent stacks applied by
4-row groups of an agent-major tile give ``FusedCollectGruPerAgent._cell``'s
outputs.

The plan: for B = 1, 1,000, 4,096 and 16,384 its tiles cover each env and
each (env, agent) row once, a 4-row group within one agent where every agent
has its own stack; its regions hold what the kernel keeps there within the
232,448 bytes a block may take.  Over every id ``register_all`` registers
(images included) with 0, 2 and 8 message bits, one stack and N, at (embed,
GRU) (128, 128), it admits and refuses exactly as the one-thread-per-env
kernel's wrapper did (copied below as ``old_rule``); at other widths it
admits what that rule admitted; past the registered ids it refuses what that
rule refused and admits what it admitted, the per-agent mode with its
observation tile in chunks where a tile of 8 envs does not hold it whole.
The main shape runs two blocks an SM, B = 4,096 at least 128 blocks.
"""
import dataclasses

import numpy as np
import pytest
import torch

from rware_tpu_torch.models.networks import (
    gru_collect_step,
    init_recurrent_actor_critic,
    gru_to_arrays,
    ordered_matmul,
    sigmoid_f32,
    split_heads,
)
from rware_tpu_torch.ops.fused_rollout import (
    COLLECT_GRU_REGIONS,
    SMEM_LIMIT,
    build_fused_collect_gru,
    build_fused_collect_gru_per_agent,
    collect_gru_plan,
)
from rware_tpu_torch.registry import SIZES, parse_env_id

torch.set_num_threads(1)

PREFIXES = ("rware", "rware-img", "rware-imgdict", "rware-img-Nd", "rware-imgdict-Nd")
RT = 4  # rows of a thread's register tile (csrc/collect_gru.cuh RW_GRU_RT)


def bf16(x):
    """float32 values rounded to bf16, as a float32 numpy array."""
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(torch.bfloat16).float().numpy()


def bf16_values(rng, shape, lo=-20, hi=2):
    """bf16-exact float32 values, signs mixed, exponents spread over 2^lo to
    2^hi."""
    mant = rng.uniform(1.0, 2.0, shape) * rng.choice([-1.0, 1.0], shape)
    return bf16(mant * np.exp2(rng.integers(lo, hi + 1, shape)))


def fma_chain(x, w):
    """``x @ w`` as the kernel sums it: k ascending, each step ``acc + x *
    w`` rounded to float32 once (float64 holds the product of two bf16
    values exactly, and rounding an f32 sum through float64 is innocuous: 53
    >= 2 * 24 + 2 bits)."""
    acc = np.zeros((x.shape[0], w.shape[1]), dtype=np.float32)
    for k in range(x.shape[1]):
        acc = (acc.astype(np.float64)
               + x[:, k:k + 1].astype(np.float64) * w[k].astype(np.float64)).astype(np.float32)
    return acc


def same_bits(a, b) -> bool:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("k_in,n_out", [(45, 128), (71, 128), (143, 128), (128, 384)])
def test_fma_chain_on_bf16_operands_equals_ordered_matmul(k_in, n_out):
    """The embed (L x E at the registered lengths 45, 71, 143) and the gate
    matrices (128 x 384, either side)."""
    rng = np.random.default_rng(k_in + n_out)
    x = bf16_values(rng, (64, k_in))
    w = bf16_values(rng, (k_in, n_out))
    want = ordered_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert same_bits(want, fma_chain(x, w))


def tile_cell(arrays, h, obs, msg_bits):
    """The cell as csrc/collect_gru.cuh computes it, in float32 numpy: the
    three products as FMA chains (gi and gh two sums from zero), then the
    kernel's epilogue, each operation rounded once; the heads as
    ``ordered_matmul`` (the kernel keeps them separately rounded)."""
    we, be, wi, bi, wh, bhn, wc, bc = (a.detach().float().numpy() for a in arrays)
    hg = wh.shape[0]
    f = np.float32
    tanh = lambda v: torch.tanh(torch.from_numpy(v)).numpy()  # noqa: E731
    e = bf16(tanh(bf16(fma_chain(bf16(obs), bf16(we)) + be[0])))
    gi, gh = fma_chain(e, bf16(wi)), fma_chain(h, bf16(wh))
    sig = lambda v: sigmoid_f32(torch.from_numpy(v)).numpy()  # noqa: E731
    r = bf16(sig((gi[:, :hg] + gh[:, :hg]) + bi[0, :hg]))
    z = bf16(sig((gi[:, hg:2 * hg] + gh[:, hg:2 * hg]) + bi[0, hg:2 * hg]))
    in_b = bf16(gi[:, 2 * hg:] + bi[0, 2 * hg:])
    hn_b = bf16(gh[:, 2 * hg:] + bhn[0])
    n = bf16(tanh(bf16(in_b + bf16(r * hn_b))))
    new_h = bf16(bf16(bf16(f(1.0) - z) * n) + bf16(z * h))
    heads = ordered_matmul(torch.from_numpy(new_h), torch.from_numpy(wc)).numpy() + bc[0]
    return split_heads(torch.from_numpy(heads), msg_bits), new_h


def random_cell_case(embed, hidden, msg_bits, rows, seed, length=71):
    """A recurrent actor-critic with nonzero biases, a bf16 carry and 0/1/2
    observations."""
    net = init_recurrent_actor_critic(length, 5, hidden, embed, seed, msg_bits)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # a zero bias hides where it is rounded
        for p in net.parameters():
            if p.dim() == 1:
                p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    rng = np.random.default_rng(seed)
    h = bf16(rng.uniform(-1, 1, (rows, hidden)))
    obs = bf16(rng.integers(0, 3, (rows, length)) * 0.5)
    return [a.detach() for a in gru_to_arrays(net)], h, obs


@pytest.mark.parametrize("embed,hidden", [(128, 128), (24, 40)])
@pytest.mark.parametrize("msg_bits", [0, 2])
def test_tile_cell_equals_gru_collect_step(embed, hidden, msg_bits):
    arrays, h, obs = random_cell_case(embed, hidden, msg_bits, 64, embed + msg_bits)
    (heads, value), new_h = tile_cell(arrays, h, obs, msg_bits)
    want_heads, want_value, want_h = gru_collect_step(arrays, torch.from_numpy(h),
                                                      torch.from_numpy(obs), msg_bits)
    assert same_bits(want_h, new_h)
    assert same_bits(want_value, value)
    if msg_bits:
        assert same_bits(want_heads[0], heads[0]) and same_bits(want_heads[1], heads[1])
    else:
        assert same_bits(want_heads, heads)


def test_fma_chain_with_f32_head_weights_differs_from_ordered_matmul():
    """The heads read bf16 new h and f32 Wc: their products are not exact,
    so the kernel keeps separate roundings there."""
    rng = np.random.default_rng(0)
    new_h = bf16(np.tanh(rng.normal(size=(256, 128))))
    wc = (rng.normal(size=(128, 6)) * 0.1).astype(np.float32)
    want = ordered_matmul(torch.from_numpy(new_h), torch.from_numpy(wc)).numpy()
    assert not same_bits(want, fma_chain(new_h, wc))


@pytest.mark.parametrize("env_id", ["rware-tiny-2ag-v2", "rware-small-4ag-v2"])
def test_per_agent_stacks_by_row_groups_equal_the_cell(env_id):
    """K2d′'s tile: rows agent-major (row i * te + e), each 4-row group run
    with the stack of its agent, gives ``FusedCollectGruPerAgent._cell``'s
    logits, value and new h bit for bit."""
    cfg = parse_env_id(env_id)
    n, te, length = cfg.n_agents, 8, cfg.policy_obs_length
    collect = build_fused_collect_gru_per_agent(cfg, 2, (24, 40))
    nets = []
    for i in range(n):
        arrays, _, _ = random_cell_case(24, 40, 0, 1, 10 + i, length)
        nets.append(arrays)
    stacked = [torch.stack(blocks) for blocks in zip(*nets)]
    rng = np.random.default_rng(5)
    h = bf16(rng.uniform(-1, 1, (te, n, 40)))
    obs = bf16(rng.integers(0, 3, (te, n, length)) * 0.5)
    logits, value, _, want_h = collect._cell(stacked, torch.from_numpy(h), torch.from_numpy(obs))
    rows = n * te
    tile_h = h.transpose(1, 0, 2).reshape(rows, 40)  # agent-major
    tile_x = obs.transpose(1, 0, 2).reshape(rows, length)
    got_h = np.zeros_like(tile_h)
    got_heads = np.zeros((rows, 6), dtype=np.float32)
    for r0 in range(0, rows, RT):
        stack = r0 // te
        assert (r0 + RT - 1) // te == stack  # the group runs one agent's stack
        (lg, v), nh = tile_cell([a[stack] for a in stacked], tile_h[r0:r0 + RT],
                                tile_x[r0:r0 + RT], 0)
        got_h[r0:r0 + RT] = nh
        got_heads[r0:r0 + RT, :5], got_heads[r0:r0 + RT, 5] = lg.numpy(), v.numpy()
    unmajor = lambda x: x.reshape(n, te, -1).transpose(1, 0, 2)  # noqa: E731
    assert same_bits(want_h, unmajor(got_h))
    assert same_bits(logits, unmajor(got_heads[:, :5]))
    assert same_bits(value, unmajor(got_heads[:, 5:])[..., 0])


def old_rule(length, hidden, n_agents, msg_bits, per_agent):
    """Admitted by the wrapper of the kernel before this plan: one thread an
    env, 128, 64 or 32 threads, each thread's observation, embedding and
    hidden a column of the tiles, beside the f32 bias and head blocks of one
    stack (K2c), or of the N stacks where they fit and else none (K2d′)."""
    embed, hg = hidden
    ac = 5 + 1 + msg_bits

    def smem(threads, stacks):
        f32 = stacks * (embed + 4 * hg + hg * ac + ac)
        return ((4 * f32 + 15) // 16) * 16 + 2 * (length + embed + hg) * threads

    stacks = 1
    if per_agent and n_agents > 1:
        stacks = n_agents if any(smem(t, n_agents) <= SMEM_LIMIT for t in (128, 64, 32)) else 0
    return any(smem(t, stacks) <= SMEM_LIMIT for t in (128, 64, 32))


def registered_configs(prefix, bits=(0, 2, 8)):
    """The configs of ``register_all(image=True)``'s ids under ``prefix`` with
    ``bits`` message bits, one for each (observation length, agents, bits)."""
    seen = {}
    for size in SIZES:
        for n in range(1, 20):
            for diff in ("", "-easy", "-hard"):
                try:
                    cfg = parse_env_id(f"{prefix}-{size}-{n}ag{diff}-v2")
                except ValueError:  # a queue longer than the shelves
                    continue
                for m in bits:
                    c = dataclasses.replace(cfg, msg_bits=m)
                    seen.setdefault((c.policy_obs_length, n, m), c)
    return list(seen.values())


def check_plan(plan, cfg, hidden, n_stacks):
    """The invariants the kernel's launch check (``collect_gru_plan_ok``) and
    its indexing rely on."""
    n, m, length = cfg.n_agents, cfg.msg_bits, cfg.policy_obs_length
    embed, hg = hidden
    ac = 5 + 1 + m
    ws = 0 if plan.heads_global else n_stacks
    need = dict(be=ws * embed * 4, bi=ws * 3 * hg * 4, bhn=ws * hg * 4, wc=ws * hg * ac * 4,
                bc=ws * ac * 4, x=(plan.kx or max(length, embed)) * plan.rs * 2,
                e=embed * plan.rs * 2 if plan.kx else 0, h=hg * plan.rs * 2,
                ring=3 * plan.ring_stacks * plan.kc * max(embed, hg) * 2,
                out=plan.rows * plan.hrs * 4, view=plan.te * plan.vs * 4, done=plan.te)
    assert plan.offsets[0] == 0 and len(plan.offsets) == len(COLLECT_GRU_REGIONS) + 1
    assert list(plan.offsets) == sorted(plan.offsets)  # no region overlaps the next
    for name in COLLECT_GRU_REGIONS:
        start, end = plan.region(name)
        assert start % 16 == 0 and end - start >= need[name], name
    assert plan.smem <= SMEM_LIMIT
    assert plan.rows % 8 == 0 and plan.rows >= n * plan.te and plan.rs >= plan.rows
    assert plan.hrs >= ac  # logits, value, message logits; then action, logp, reward
    layout = cfg.compile_layout()  # agents (2 words), messages, queue, shelves
    assert plan.vs >= 2 * n + n * m + cfg.request_queue_size + layout.n_shelves
    # a thread a row and more to store beside them; a thread for an output
    # group of every row group
    assert plan.threads % 32 == 0 and plan.threads <= 512 and plan.threads >= plan.rows + 32
    assert max(embed, hg) // 8 <= plan.threads
    assert 0 < plan.carveout <= 100 and plan.kc >= 1
    # the ring holds a chunk of every stack one set of rows runs: sets of as
    # many 4-row groups as give each 8-column job a thread
    spans = 1
    for cols in (embed, hg):
        per_set = RT * min(plan.rows // RT, plan.threads // (cols // 8))
        for r0 in range(0, plan.rows, per_set):
            last = min(r0 + per_set, plan.rows) - 1
            spans = max(spans, last // plan.te - r0 // plan.te + 1 if n_stacks > 1 else 1)
    assert plan.ring_stacks >= spans
    if n_stacks > 1:
        assert plan.te % 8 == 0 and plan.rows == n * plan.te
    if plan.kx:  # per agent only: whole 16-byte runs of features and whole ring chunks
        assert n_stacks > 1 and plan.kx % 8 == 0 and plan.kx % plan.kc == 0
        assert 0 < plan.kx < length


@pytest.mark.parametrize("prefix", PREFIXES)
def test_plan_admits_the_registered_ids_as_before(prefix):
    configs = registered_configs(prefix)
    assert configs
    for cfg in configs:
        n = cfg.n_agents
        for n_stacks in sorted({1, n}):
            assert old_rule(cfg.policy_obs_length, (128, 128), n, cfg.msg_bits, n_stacks > 1)
            for b in (16384, 4096):
                check_plan(collect_gru_plan(cfg, (128, 128), n_stacks, b), cfg, (128, 128),
                           n_stacks)


@pytest.mark.parametrize("hidden", [(64, 64), (24, 40), (256, 128), (128, 512)])
def test_plan_admits_what_the_old_rule_admitted_at_other_widths(hidden):
    for prefix in ("rware", "rware-imgdict"):
        for cfg in registered_configs(prefix, (0, 2)):
            n = cfg.n_agents
            for n_stacks in sorted({1, n}):
                if old_rule(cfg.policy_obs_length, hidden, n, cfg.msg_bits, n_stacks > 1):
                    check_plan(collect_gru_plan(cfg, hidden, n_stacks), cfg, hidden, n_stacks)


# Past the registered ids (sensor range 1): nothing the old rule admitted is
# refused; where the per-agent mode's smallest tile (8 envs, 8 N rows, each a
# column of both tiles) does not fit a block beside its views (many agents and
# a long observation), its observation tile goes in chunks.
NARROWED = set()


def test_plan_at_longer_sensor_ranges_refuses_as_the_old_rule_with_stated_narrowing():
    narrowed = set()
    for sensor in (2, 3, 4, 5):
        for prefix in ("rware", "rware-img", "rware-imgdict"):
            for n in (1, 2, 3, 4, 8, 16, 19):
                env_id = f"{prefix}-{sensor}s-tiny-{n}ag-v2"
                base = parse_env_id(env_id)
                for m in (0, 2):
                    cfg = dataclasses.replace(base, msg_bits=m)
                    for per_agent in sorted({False, n > 1}):
                        old = old_rule(cfg.policy_obs_length, (128, 128), n, m, per_agent)
                        try:
                            plan = collect_gru_plan(cfg, (128, 128), n if per_agent else 1)
                            check_plan(plan, cfg, (128, 128), n if per_agent else 1)
                            new = True
                        except ValueError:
                            new = False
                        assert old or not new, (env_id, m, per_agent)  # refused before
                        if old and not new:
                            assert per_agent, (env_id, m)
                            narrowed.add((env_id, m))
    assert narrowed == NARROWED


@pytest.mark.parametrize("b", [1, 1000, 4096, 16384])
@pytest.mark.parametrize("env_id,per_agent", [("rware-tiny-2ag-v2", False),
                                              ("rware-tiny-2ag-v2", True),
                                              ("rware-small-4ag-v2", True),
                                              ("rware-tiny-16ag-v2", False),
                                              ("rware-large-19ag-v2", True)])
def test_tiles_cover_each_env_and_row_once(b, env_id, per_agent):
    cfg = parse_env_id(env_id)
    n = cfg.n_agents
    plan = collect_gru_plan(cfg, (128, 128), n if per_agent else 1, b)
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
                    assert r // RT * RT // plan.te == i  # its 4-row group runs stack i
        assert rows.max() == 1
    assert (envs == 1).all()


def test_main_shapes_fill_the_card():
    """tiny-2ag, (embed, GRU) (128, 128): B=16,384 takes 64 envs (128 rows) a
    block on 256 threads, 256 blocks, two an SM, so with two and eight
    message bits, with images and per agent; without message bits its weight
    ring takes three chunks of 32 rows and its f32 blocks sit in shared
    memory.  B=4,096 (recurrent SEAC's batch) takes 32 envs a block, 128
    blocks."""
    cfg = parse_env_id("rware-tiny-2ag-v2")
    for c in (cfg, dataclasses.replace(cfg, msg_bits=2), dataclasses.replace(cfg, msg_bits=8),
              parse_env_id("rware-img-tiny-2ag-v2")):
        for n_stacks in (1, 2):
            plan = collect_gru_plan(c, (128, 128), n_stacks, 16384)
            assert (plan.te, plan.rows, plan.threads, plan.blocks(16384)) == (64, 128, 256, 256)
            assert plan.blocks_per_sm == 2 and plan.ring_stacks == 1 and plan.kc >= 16
            assert c.msg_bits or (plan.kc == 32 and not plan.heads_global), c
            plan = collect_gru_plan(c, (128, 128), n_stacks, 4096)
            assert (plan.te, plan.rows, plan.blocks(4096)) == (32, 64, 128)
            assert plan.blocks_per_sm == 2 and plan.ring_stacks == n_stacks


def test_wrappers_take_the_plan_and_a_forced_route():
    cfg = parse_env_id("rware-tiny-2ag-v2")
    collect = build_fused_collect_gru(cfg, 4, hidden=(24, 40))
    assert collect.plan(1000) == collect_gru_plan(cfg, (24, 40), 1, 1000)
    per_agent = build_fused_collect_gru_per_agent(cfg, 4)
    assert not per_agent.plan(4096).heads_global  # two agents' blocks fit beside the tiles
    per_agent.heads_global = True
    forced = per_agent.plan(4096)
    assert forced.heads_global and forced.region("wc") == (0, 0) and forced.te == 32
    big = build_fused_collect_gru_per_agent(parse_env_id("rware-large-8ag-v2"), 4)
    assert big.plan(4096).heads_global and big.plan(4096).te % 8 == 0
    big.heads_global = False
    assert not big.plan(1000).heads_global and big.plan(1000).region("wc")[1] > 0
    with pytest.raises(ValueError, match="widths up to"):
        collect_gru_plan(cfg, (128, 4096))
