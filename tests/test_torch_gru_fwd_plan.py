"""K9's launch plan (``rware_tpu_torch/ops/fused_gru.py::gru_obs_fwd_plan``)
on the CPU, and the premise of its split.

For every observation length the registry's ids give (flattened, image and
image-dict observations, directional or not, sensor ranges 1-5, and the
flattened ones with two message bits), for embed and hidden widths (128, 128),
(24, 40) (multiples of 8 but not of 16: the tensor-core tiles are padded) and
(8, 8), for 2 and 16 agents and for bands from 1 env to 4,096:

- the blocks' tiles cover the band's sequences exactly once, and the runs of
  trajectory rows a block reads each step (one, or two where the band wraps
  past the last env) reach each of the band's (env, agent) rows once, in the
  band's order;
- no block asks for more shared memory than one block may take on the H100
  (232,448 bytes), and the staging buffer holds a step's runs at any
  alignment of the observations in device memory;
- a block takes the smallest tile whose blocks fit the card's 132 SMs in one
  wave, or the largest smaller one that fits its shared memory;
- widths the kernel does not take raise the wrapper's ``ValueError``.

The premise: the kernel computes the input side of a step, e = bf16(tanh(
bf16(obs We + be))) and iall = bf16(e Wi + bi), before that step's h Wh, from
the observation rows it staged and repacked; each block runs its own
sequences.  A torch emulation of that split and of the kernel's data path
(the runs copied as 16-byte chunks into a staging buffer at a given
alignment, repacked into the padded tile, hseq written from the hidden
buffer before the reset), each product in the plain version's own torch op,
gives ``FusedGruObsFwd.plain``'s hseq bit for bit.
"""
import dataclasses

import pytest
import torch

from rware_tpu_torch.models.networks import GruDims, gru_replay_cell, rnd_bf16
from rware_tpu_torch.ops.fused_gru import (
    SMEM_MAX,
    SWEEP_SMS,
    _fwd_smem,
    build_fused_gru_obs_fwd,
    gru_obs_fwd_plan,
)
from rware_tpu_torch.registry import parse_env_id

torch.set_num_threads(1)

WIDTHS = [(128, 128), (24, 40), (8, 8)]
AGENTS = [2, 16]
BANDS = [1, 7, 640, 2048, 4096]
B_ENVS = 16384  # the training batch: bands of up to a quarter of it
STARTS = [0, 5, B_ENVS - 3000]  # the last wraps the bands past 3,000 envs


def _obs_lengths():
    lengths = set()
    for sensor in ("", "-2s", "-3s", "-4s", "-5s"):
        for kind in ("", "-img", "-imgdict", "-img-Nd", "-imgdict-Nd"):
            cfg = parse_env_id(f"rware{kind}{sensor}-tiny-2ag-v2")
            lengths.add(cfg.policy_obs_length)
            if not kind:
                lengths.add(dataclasses.replace(cfg, msg_bits=2).policy_obs_length)
    return sorted(lengths)


OBS_LENGTHS = _obs_lengths()


def _plans(widths, n_agents):
    e, hg = widths
    for length in OBS_LENGTHS:
        for n_env in BANDS:
            yield (length, n_env), gru_obs_fwd_plan(GruDims(length, e, hg, 5), n_agents, n_env)


def _covers_once(ranges, n):
    """``ranges`` are non-empty, each starts where the one before stopped, the
    first at 0 and the last stops at ``n``: every index once."""
    if not ranges or ranges[0].start != 0 or ranges[-1].stop != n:
        return False
    return all(r.step == 1 and len(r) > 0 for r in ranges) and all(
        a.stop == b.start for a, b in zip(ranges, ranges[1:]))


def _chunks(first_elem, count):
    """(aligned start, 16-byte chunks) of ``count`` bf16 elements from element
    ``first_elem`` of a 16-byte-aligned buffer."""
    off = first_elem % 8
    return first_elem - off, -(-(off + count) // 8)


def test_the_registry_gives_many_obs_lengths():
    assert 71 in OBS_LENGTHS and len(OBS_LENGTHS) >= 10 and max(OBS_LENGTHS) > 512


@pytest.mark.parametrize("n_agents", AGENTS)
@pytest.mark.parametrize("widths", WIDTHS)
def test_tiles_cover_each_sequence_once(widths, n_agents):
    for (length, n_env), plan in _plans(widths, n_agents):
        assert plan.n_seq == n_env * n_agents and plan.blocks == -(-plan.n_seq // plan.rows)
        assert _covers_once(plan.tiles(), plan.n_seq), (widths, length, n_env)
    # the runs of rows at each band start, against the band's (env, agent) rows
    plan = gru_obs_fwd_plan(GruDims(71, widths[0], widths[1], 5), n_agents, 4096)
    for start in STARTS:
        want = [((start + q // n_agents) % B_ENVS) * n_agents + q % n_agents
                for q in range(plan.n_seq)]
        got, wrapped = [], 0
        for blk, tile in enumerate(plan.tiles()):
            runs = plan.obs_runs(blk, start, B_ENVS)
            assert 1 <= len(runs) <= 2 and sum(n for _, n in runs) == len(tile)
            wrapped += len(runs) == 2 or (runs[0][0] == 0 and blk > 0)
            got += [r for first, n in runs for r in range(first, first + n)]
        assert got == want, start
        assert wrapped == (start + 4096 > B_ENVS)


@pytest.mark.parametrize("n_agents", AGENTS)
@pytest.mark.parametrize("widths", WIDTHS)
def test_no_block_asks_for_more_shared_memory_than_it_has(widths, n_agents):
    assert SMEM_MAX == 232_448
    for (length, n_env), plan in _plans(widths, n_agents):
        assert 0 < plan.smem <= SMEM_MAX, (widths, length, n_env, plan.smem)
        # the worst alignment of both runs still fits the staging buffer
        n1 = plan.rows // 2
        worst = sum(_chunks(7, n * length)[1] for n in (n1, plan.rows - n1))
        assert 8 * worst <= plan.stage and 8 * _chunks(7, plan.rows * length)[1] <= plan.stage


@pytest.mark.parametrize("n_agents", AGENTS)
def test_blocks_fill_the_card_in_one_wave(n_agents):
    for length in OBS_LENGTHS:
        for n_env in BANDS + [64, 8192]:
            plan = gru_obs_fwd_plan(GruDims(length, 128, 128, 5), n_agents, n_env)
            n_seq = n_env * n_agents
            wave = next((r for r in (16, 32, 64) if -(-n_seq // r) <= SWEEP_SMS), 64)
            assert plan.rows <= wave
            if plan.rows < wave:  # the next larger tile does not fit
                assert _fwd_smem(length, 128, 128, 2 * plan.rows) > SMEM_MAX
    # the main shape: a 4,096-env band of tiny-2ag, one wave of 128 blocks; the
    # learning runs' 1,024-env bands; tiny-16ag's many blocks; sensor range 3
    main = gru_obs_fwd_plan(GruDims(71, 128, 128, 5), 2, 4096)
    assert (main.rows, main.blocks) == (64, 128)
    assert gru_obs_fwd_plan(GruDims(71, 128, 128, 5), 2, 1024).rows == 16
    assert gru_obs_fwd_plan(GruDims(71, 128, 128, 5), 16, 4096).blocks == 1024
    assert gru_obs_fwd_plan(GruDims(351, 128, 128, 5), 2, 4096).rows == 32


@pytest.mark.parametrize("widths", [(128, 256), (12, 128), (128, 20), (136, 8)])
def test_refuses_widths_the_kernel_does_not_take(widths):
    with pytest.raises(ValueError, match="multiples of 8 up to 128"):
        gru_obs_fwd_plan(GruDims(71, widths[0], widths[1], 5), 2, 4096)


def _case(length, widths, n_agents, b, t_len, seed):
    dims = GruDims(length, widths[0], widths[1], 5)
    gen = torch.Generator().manual_seed(seed)
    weights = [torch.randn(s, generator=gen) * (0.1 if s[0] == 1 else s[0] ** -0.5)
               for s in dims.shapes[:6]]
    obs = (torch.randint(0, 3, (t_len, b, n_agents, length), generator=gen) * 0.5)
    done = torch.rand((t_len, b), generator=gen) < 0.3
    h0 = torch.rand((b, n_agents, dims.hidden), generator=gen) * 2 - 1
    return dims, weights, obs.to(torch.bfloat16), done, h0.to(torch.bfloat16)


def _emulate(plan, dims, weights, obs, done, h0, start, align):
    """The kernel's data path in torch: per block and step, the obs runs as
    16-byte chunks of a buffer whose first element sits ``align`` elements
    past a 16-byte boundary, staged, repacked into the tile, the input side,
    then h Wh and the cell; hseq from the hidden before its reset."""
    t_len, b, n, length = obs.shape
    we, be, wi, bi, wh, bhn = (w.float() for w in weights)
    # the buffer as the allocator leaves it: whole 16-byte chunks at either end
    flat = torch.cat([torch.zeros(align, dtype=obs.dtype), obs.reshape(-1),
                      torch.zeros(8, dtype=obs.dtype)])
    hseq = torch.empty((t_len, plan.n_seq, dims.hidden), dtype=torch.bfloat16)
    for blk, tile in enumerate(plan.tiles()):
        runs = plan.obs_runs(blk, start, b)
        rows = torch.tensor([r for first, k in runs for r in range(first, first + k)])
        h = h0.reshape(b * n, -1)[rows].float()
        for t in range(t_len):
            stage, offsets = torch.zeros(plan.stage, dtype=obs.dtype), []
            used = 0
            for first, k in runs:
                lo, n_chunks = _chunks(align + (t * b * n + first) * length, k * length)
                stage[used:used + 8 * n_chunks] = flat[lo:lo + 8 * n_chunks]
                offsets += [used + (align + (t * b * n + first) * length) % 8 + i * length
                            for i in range(k)]
                used += 8 * n_chunks
            x = torch.stack([stage[o:o + length] for o in offsets]).float()
            e = rnd_bf16(torch.tanh(rnd_bf16(x @ rnd_bf16(we) + be[0])))  # the input side
            iall = rnd_bf16(e @ rnd_bf16(wi) + bi[0])
            new_h = gru_replay_cell(wh, bhn, h, iall)  # h Wh and the gates
            hseq[t, tile.start:tile.stop] = new_h.to(torch.bfloat16)
            h = torch.where(done[t, rows // n][:, None], 0.0, new_h)
    return hseq.reshape(t_len, -1, n, dims.hidden)


# (obs length, (embed, hidden), agents, envs, steps, band): the main widths, the
# padded ones, tiny-16ag's agents, sensor range 3's and 5's long rows (smaller
# tiles), bands that wrap, a band of one env
SPLIT_CASES = [
    (71, (128, 128), 2, 300, 4, (250, 100)),
    (71, (24, 40), 2, 300, 4, (290, 60)),
    (45, (8, 8), 16, 40, 3, (35, 10)),
    (351, (128, 128), 2, 80, 3, (75, 10)),
    (1097, (128, 128), 2, 40, 3, (39, 1)),
]


@pytest.mark.parametrize("length,widths,n_agents,b,t_len,band", SPLIT_CASES)
def test_the_split_gives_the_plain_k9s_bits(length, widths, n_agents, b, t_len, band):
    dims, weights, obs, done, h0 = _case(length, widths, n_agents, b, t_len, 3)
    fwd = build_fused_gru_obs_fwd(dims)
    want = fwd.plain(weights, obs, done, h0, *band)
    plan = gru_obs_fwd_plan(dims, n_agents, band[1])
    for align in (0, 3, 7):
        got = _emulate(plan, dims, weights, obs, done, h0, band[0], align)
        assert torch.equal(got, want), (align, float((got.float() - want.float()).abs().max()))
    assert fwd.launches == 0  # the CPU wrapper is the plain version
