"""K12's and K13's launch plan (``rware_tpu_torch/ops/fused_gru.py::
gru_seq_bwd_plan``) on the CPU, and the premise of their split.

For hidden widths 8, 40 (a multiple of 8 but not of 16: the tensor-core tiles
are padded) and 128, for 2 and 16 agents, for bands from 1 env to 4,096 and
for both kernels:

- the sweep's tiles, the prologue's tiles, the prologue blocks' runs of tiles
  and the dWh chunks each cover their band's sequences or samples exactly
  once, and a band that wraps past the last env reaches each of its (env,
  agent) sequences once;
- the scratch holds T n_env N samples;
- no kernel asks for more shared memory than one block may take on the H100
  (232,448 bytes), and two prologue blocks fit an SM;
- the sweep takes the smallest tile height whose blocks fit the card's 132
  SMs in one wave, and is K10's (the same shared memory, K13's W_head^T
  besides);
- widths the kernels do not take raise the wrapper's ``ValueError``.

The premise: the kernels compute the heads, the loss and ``hh = hprev Wh``
for the whole band before the sweep and store r, z (f32), hhn, n (bf16) and
dheads (f32); a torch emulation of that split, each product in the plain
version's own torch op, gives the plain versions' d_iall, dh0, dbhn and dWh
bit for bit, and the head gradients and metric sums summed in the plan's
tile order agree with the plain version's within 1e-6 of the sum of the
terms' magnitudes.
"""
import pytest
import torch

from rware_tpu_torch.models.networks import GruDims, rnd_bf16, sigmoid_f32, split_gates
from rware_tpu_torch.ops.fused_gru import (
    SMEM_MAX,
    SWEEP_SMS,
    band_index,
    build_fused_gru_loss_bwd,
    build_fused_gru_seq_bwd,
    build_fused_gru_seq_fwd,
    gru_obs_bwd_plan,
    gru_seq_bwd_plan,
)
from rware_tpu_torch.testing import random_gru_seq_case

torch.set_num_threads(1)

HIDDEN = [128, 40, 8]
AGENTS = [2, 16]
BANDS = [1, 7, 640, 2048, 4096]
T_LENS = [128, 3]
SM_SMEM = 233_472  # shared memory of one H100 SM, bytes (228 KB)


def _plans(hidden, n_agents, loss):
    for n_env in BANDS:
        for t_len in T_LENS:
            yield (t_len, n_env), gru_seq_bwd_plan(GruDims(71, 128, hidden, 5), t_len, n_agents,
                                                   n_env, loss)


def _covers_once(ranges, n):
    """``ranges`` are non-empty, each starts where the one before stopped, the
    first at 0 and the last stops at ``n``: every index once."""
    if not ranges or ranges[0].start != 0 or ranges[-1].stop != n:
        return False
    return all(r.step == 1 and len(r) > 0 for r in ranges) and all(
        a.stop == b.start for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("loss", [False, True])
@pytest.mark.parametrize("n_agents", AGENTS)
@pytest.mark.parametrize("hidden", HIDDEN)
def test_tiles_cover_each_sequence_and_sample_once(hidden, n_agents, loss):
    for (t_len, n_env), plan in _plans(hidden, n_agents, loss):
        assert plan.n_seq == n_env * n_agents and plan.n_samples == t_len * plan.n_seq
        assert _covers_once(plan.sweep_tiles(), plan.n_seq), (hidden, t_len, n_env)
        assert _covers_once(plan.sample_tiles(), plan.n_samples)
        assert _covers_once(plan.prologue_tiles(), plan.n_tiles)
        assert _covers_once(plan.chunks(), plan.n_samples)
        assert plan.chunk % 64 == 0 and plan.n_chunks <= 128
        assert plan.prologue_blocks <= 8 * SWEEP_SMS
        # a band that wraps past the last env: each (env, agent) of the band once
        b = n_env + 5
        env = band_index(b - 3, n_env, b, "cpu")
        seqs = [(int(env[q // n_agents]), q % n_agents) for tile in plan.sweep_tiles()
                for q in tile]
        want = {(e, k) for e in range(b) for k in range(n_agents)
                if (e - (b - 3)) % b < n_env}
        assert len(seqs) == len(set(seqs)) and set(seqs) == want


@pytest.mark.parametrize("loss", [False, True])
@pytest.mark.parametrize("n_agents", AGENTS)
@pytest.mark.parametrize("hidden", HIDDEN)
def test_the_scratch_holds_every_sample(hidden, n_agents, loss):
    f32, bf = torch.float32, torch.bfloat16
    for _, plan in _plans(hidden, n_agents, loss):
        n = plan.n_samples
        want = {"rz": ((n, 2 * hidden), f32), "hn": ((n, 2 * hidden), bf),
                "dhhn": ((n, hidden), bf)}
        if loss:
            want["dheads"] = ((n, 8), f32)
        want["part_bhn"] = ((plan.sweep_blocks, hidden), f32)
        if loss:
            want["part_head"] = ((plan.prologue_blocks, (hidden + 1) * 6 + 4), f32)
        want["partial"] = ((plan.n_chunks, hidden * 3 * hidden), f32)
        # in the order the library takes them
        assert list(plan.scratch.items()) == list(want.items())
        assert plan.n_head == (want["part_head"][0][1] if loss else 0)


@pytest.mark.parametrize("loss", [False, True])
@pytest.mark.parametrize("n_agents", AGENTS)
@pytest.mark.parametrize("hidden", HIDDEN)
def test_no_kernel_asks_for_more_shared_memory_than_a_block_has(hidden, n_agents, loss):
    assert SMEM_MAX == 232_448
    for (t_len, n_env), plan in _plans(hidden, n_agents, loss):
        assert set(plan.smem) == {"prologue", "sweep", "wgrad"}
        assert all(0 < b <= SMEM_MAX for b in plan.smem.values()), plan.smem
        assert 2 * (plan.smem["prologue"] + 1024) <= SM_SMEM  # two blocks an SM
        k10 = gru_obs_bwd_plan(GruDims(71, 128, hidden, 5), t_len, n_agents, n_env)
        assert plan.sweep_rows == k10.sweep_rows and plan.smem["wgrad"] == k10.smem["wgrad"]
        assert plan.smem["sweep"] == k10.smem["sweep"] + (8 * 128 * 4 if loss else 0)


@pytest.mark.parametrize("loss", [False, True])
@pytest.mark.parametrize("n_agents", AGENTS)
def test_the_sweep_fills_the_card_in_one_wave(n_agents, loss):
    for n_env in BANDS + [64, 8192]:
        plan = gru_seq_bwd_plan(GruDims(71, 128, 128, 5), 128, n_agents, n_env, loss)
        n_seq = n_env * n_agents
        if n_seq <= 64 * SWEEP_SMS:
            assert plan.sweep_blocks <= SWEEP_SMS
            smaller = plan.sweep_rows // 2
            assert plan.sweep_rows == 16 or -(-n_seq // smaller) > SWEEP_SMS
        else:
            assert plan.sweep_rows == 64
    # the band shape: a 4,096-env band of tiny-2ag, 8,192 sequences in 128 blocks of 64
    plan = gru_seq_bwd_plan(GruDims(71, 128, 128, 5), 128, 2, 4096, loss)
    assert (plan.sweep_rows, plan.sweep_blocks) == (64, 128)


@pytest.mark.parametrize("loss", [False, True])
@pytest.mark.parametrize("hidden", [12, 136, 256])
def test_refuses_hidden_widths_the_kernels_do_not_take(hidden, loss):
    with pytest.raises(ValueError, match="multiples of 8 up to 128"):
        gru_seq_bwd_plan(GruDims(71, 128, hidden, 5), 128, 2, 4096, loss)


@pytest.mark.parametrize("hidden,n_actions,ok", [(128, 7, False), (120, 7, True), (128, 8, False),
                                                 (8, 0, False), (8, 1, True), (128, 6, True)])
def test_k13_refuses_head_widths_it_does_not_take(hidden, n_actions, ok):
    dims = GruDims(71, 128, hidden, n_actions)
    assert gru_seq_bwd_plan(dims, 8, 2, 64, False).n_head == 0  # K12 has no heads
    if ok:
        assert gru_seq_bwd_plan(dims, 8, 2, 64, True).n_head == (hidden + 1) * (n_actions + 1) + 4
    else:
        with pytest.raises(ValueError, match="actions"):
            gru_seq_bwd_plan(dims, 8, 2, 64, True)


# ---- the premise: the split, emulated in torch on the CPU

def _hseq(dims, a, band):
    """K11's plain hidden sequence of the band."""
    return build_fused_gru_seq_fwd(dims).plain(a["wh"], a["bhn"], a["iall"], a["done"], a["h0"],
                                               *band)


def _prologue(a, hseq, idx):
    """What the prologue stores for every step of the band, before the sweep:
    hprev, r and z as f32, hhn and n as bf16 (the plain version's ops, step by
    step)."""
    whb, bhn = rnd_bf16(a["wh"].float()), a["bhn"].float()
    out = []
    for t in range(a["iall"].shape[0]):
        if t == 0:
            hp = a["h0"][idx].float()
        else:
            hp = torch.where(a["done"][t - 1, idx][:, None, None], 0.0, hseq[t - 1].float())
        ia_r, ia_z, ia_n = split_gates(a["iall"][t].float())
        hh_r, hh_z, hh_n = split_gates(hp @ whb)
        r, z = sigmoid_f32(ia_r + hh_r), sigmoid_f32(ia_z + hh_z)
        hhn = rnd_bf16(hh_n + bhn[0])
        nn = rnd_bf16(torch.tanh(rnd_bf16(ia_n + rnd_bf16(rnd_bf16(r) * hhn))))
        out.append((hp, r, z, hhn.to(torch.bfloat16), nn.to(torch.bfloat16)))
    return out


def _sweep(a, stored, dh_out, idx):
    """The reverse sweep from the stored gates alone: (dWh, dbhn, d_iall,
    dh0)."""
    whb = rnd_bf16(a["wh"].float())
    hg = whb.shape[0]
    dwh, dbhn = torch.zeros_like(whb), torch.zeros((1, hg))
    d_iall = torch.empty_like(a["iall"])
    dc = torch.zeros(dh_out.shape[1:])
    for t in range(len(stored) - 1, -1, -1):
        hp, r, z, hhn, nn = stored[t]
        hhn, nn = hhn.float(), nn.float()
        dnh = dh_out[t] + torch.where(a["done"][t, idx][:, None, None], 0.0, dc)
        dz_pre = dnh * (hp - nn) * z * (1.0 - z)
        dn_pre = dnh * (1.0 - z) * (1.0 - nn * nn)
        dhhn = dn_pre * r
        dr_pre = dn_pre * hhn * r * (1.0 - r)
        dg3 = rnd_bf16(torch.cat([dr_pre, dz_pre, dhhn], -1))
        d_iall[t] = torch.cat([dr_pre, dz_pre, dn_pre], -1).to(torch.bfloat16)
        dc = dnh * z + dg3 @ whb.t()
        dwh += hp.reshape(-1, hg).t() @ dg3.reshape(-1, 3 * hg)
        dbhn += dhhn.reshape(-1, hg).sum(0, keepdim=True)
    return dwh, dbhn, d_iall, dc


def _tile_order_sum(plan, terms):
    """``terms`` (n_samples, k) summed as the kernels sum them: each prologue
    block over its tiles in order, each row slot of a tile across them, then
    the slots; the reduction's warp w over the blocks w, w + 8, .., then the
    eight warps' sums in order; in f32."""
    blocks = []
    for tiles in plan.prologue_tiles():
        slots = torch.zeros((64, terms.shape[1]))
        for tile in tiles:
            rows = terms[tile * 64:(tile + 1) * 64]
            slots[:rows.shape[0]] += rows
        block = torch.zeros(terms.shape[1])
        for s in range(64):
            block += slots[s]
        blocks.append(block)
    total = torch.zeros(terms.shape[1])
    for w in range(8):
        warp = torch.zeros(terms.shape[1])
        for block in blocks[w::8]:
            warp += block
        total += warp
    return total


CASES = [("rware-tiny-2ag-v2", 64, 8, (40, 40), 128, 128),
         ("rware-tiny-2ag-v2", 64, 8, (40, 40), 40, 24),
         ("rware-tiny-16ag-v2", 16, 4, (10, 10), 40, 24)]


@pytest.mark.parametrize("env_id,b,t_len,band,hidden,embed", CASES)
def test_the_split_gives_the_plain_k13s_bits(env_id, b, t_len, band, hidden, embed):
    dims, a = random_gru_seq_case(env_id, b, t_len, band, 7, "cpu", hidden=hidden, embed=embed)
    loss = build_fused_gru_loss_bwd(dims, 0.2, 0.5, 0.01)
    idx = band_index(*band, b, "cpu")
    hseq = _hseq(dims, a, band)
    want = loss(a["wh"], a["bhn"], a["whead"], a["bhead"], a["iall"], a["done"], a["h0"], hseq, a["action"], a["logp"], a["value"], a["adv"], a["target"], a["stats"],
                *band)
    assert loss.launches == 0  # CPU tensors: the plain version
    w_d_iall, w_dwh, w_dbhn, w_dwhead, w_dbhead, w_dh0, w_mets = want

    # the prologue: the heads and the loss's backward for the whole band, dheads
    # stored as the kernel stores it (f32, 8 a sample, zero past A + 1), and the gates
    whead = a["whead"].float()
    streams = [x[:, idx] for x in (a["action"], a["logp"], a["value"], a["adv"], a["target"])]
    dheads, terms = loss.heads_loss_bwd(hseq, whead, a["bhead"], streams, a["stats"])
    a1 = dims.n_actions + 1
    stored_dheads = torch.zeros(dheads.shape[:-1] + (8,))
    stored_dheads[..., :a1] = dheads
    stored = _prologue(a, hseq, idx)
    # the sweep, fed dheads W_head^T
    dwh, dbhn, d_iall, dh0 = _sweep(a, stored, stored_dheads[..., :a1] @ whead.t(), idx)
    for got, exp in ((d_iall, w_d_iall), (dh0, w_dh0), (dbhn, w_dbhn), (dwh, w_dwh)):
        assert got.dtype == exp.dtype and torch.equal(got, exp)

    # the head gradients and metric sums in the plan's tile order
    plan = gru_seq_bwd_plan(dims, t_len, a["h0"].shape[1], band[1], True)
    h2 = hseq.float().reshape(-1, hidden)
    g2 = stored_dheads[..., :a1].reshape(-1, a1)
    rows = torch.cat([h2, torch.ones((h2.shape[0], 1))], 1)  # the bias as a row of ones
    head_terms = (rows[:, :, None] * g2[:, None, :]).reshape(h2.shape[0], -1)
    met_terms = torch.stack([x.reshape(-1) for x in terms], 1)
    got = _tile_order_sum(plan, torch.cat([head_terms, met_terms], 1))
    exp = torch.cat([w_dwhead.reshape(-1), w_dbhead, w_mets])
    scale = torch.cat([head_terms, met_terms], 1).abs().sum(0)
    assert got.shape == (plan.n_head,)
    assert bool(((got - exp).abs() <= 1e-6 * scale).all()), float(((got - exp).abs() / scale).max())


@pytest.mark.parametrize("env_id,b,t_len,band,hidden,embed", CASES)
def test_the_split_gives_the_plain_k12s_bits(env_id, b, t_len, band, hidden, embed):
    dims, a = random_gru_seq_case(env_id, b, t_len, band, 9, "cpu", hidden=hidden, embed=embed)
    bwd = build_fused_gru_seq_bwd(dims)
    idx = band_index(*band, b, "cpu")
    hseq = _hseq(dims, a, band)
    gen = torch.Generator().manual_seed(3)
    dhseq = (torch.randn(hseq.shape, generator=gen) * 1e-2).to(torch.bfloat16)
    want = bwd(a["wh"], a["bhn"], a["iall"], a["done"], a["h0"], hseq, dhseq, *band)
    assert bwd.launches == 0
    got = _sweep(a, _prologue(a, hseq, idx), dhseq.float(), idx)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)

