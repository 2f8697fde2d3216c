"""K11's launch plan (``rware_tpu_torch/ops/fused_gru.py::gru_seq_fwd_plan``)
on the CPU, and the premise of its data path.

For hidden widths 128, 40 (a multiple of 8 but not of 16: the tensor-core
tiles are padded) and 8, for 2 and 16 agents and for bands of 1 to 4,096
envs:

- the blocks' tiles cover the band's sequences exactly once;
- no block asks for more shared memory than one block may take on the H100
  (232,448 bytes), and a second whole iall tile would not fit at the
  training shape (the reason the kernel keeps one);
- a block takes the smallest tile whose blocks fit the card's 132 SMs in one
  wave, else 64 sequences;
- widths the kernel does not take raise the wrapper's ``ValueError``.

The premise: the kernel brings step t + 1's iall into its one shared tile
while step t runs, so each warp must have taken its hidden units' iall of
step t into registers before the next run lands; it computes h Wh from the
hidden buffer, writes hseq from the buffer at the next step's start and
resets the buffer's rows after that.  A torch emulation of that data path
(the block's run of band rows copied into the padded tile, each warp's
columns 8w .. 8w + 8 of each gate taken out before the next run overwrites
the tile, two hidden buffers, rows past the band zero), each product in the
plain version's own torch op, gives ``FusedGruSeqFwd.plain``'s hseq bit for
bit, on bands that wrap, at T of 3 and 128 and at tiles of 16, 32 and 64.
"""
import pytest
import torch

from rware_tpu_torch.models.networks import GruDims, gru_replay_cell
from rware_tpu_torch.ops.fused_gru import (
    SMEM_MAX,
    SWEEP_SMS,
    _seq_fwd_smem,
    build_fused_gru_seq_fwd,
    gru_seq_fwd_plan,
)
from rware_tpu_torch.testing import random_gru_seq_case

torch.set_num_threads(1)

WIDTHS = [(128, 128), (24, 40), (8, 8)]  # (embed, hidden)
AGENTS = [2, 16]
BANDS = [1, 7, 640, 2048, 4096]
PAD = 8  # bf16 columns added to each shared-memory row


def _r16(x):
    return -(-x // 16) * 16


def _covers_once(ranges, n):
    """``ranges`` are non-empty, each starts where the one before stopped, the
    first at 0 and the last stops at ``n``: every index once."""
    if not ranges or ranges[0].start != 0 or ranges[-1].stop != n:
        return False
    return all(r.step == 1 and len(r) > 0 for r in ranges) and all(
        a.stop == b.start for a, b in zip(ranges, ranges[1:]))


def _plans(widths, n_agents):
    for n_env in BANDS:
        yield n_env, gru_seq_fwd_plan(GruDims(71, widths[0], widths[1], 5), n_agents, n_env)


@pytest.mark.parametrize("n_agents", AGENTS)
@pytest.mark.parametrize("widths", WIDTHS)
def test_tiles_cover_each_sequence_once(widths, n_agents):
    for n_env, plan in _plans(widths, n_agents):
        assert plan.n_seq == n_env * n_agents and plan.blocks == -(-plan.n_seq // plan.rows)
        assert _covers_once(plan.tiles(), plan.n_seq), (widths, n_env)


@pytest.mark.parametrize("n_agents", AGENTS)
def test_no_block_asks_for_more_shared_memory_than_it_has(n_agents):
    assert SMEM_MAX == 232_448
    for hidden in range(8, 129, 8):
        for n_env in BANDS:
            plan = gru_seq_fwd_plan(GruDims(71, 8, hidden, 5), n_agents, n_env)
            assert 0 < plan.smem <= SMEM_MAX, (hidden, n_env, plan.smem)
            assert plan.smem == _seq_fwd_smem(hidden, plan.rows)
    # Wh 100,352 + the hidden's two buffers 34,816 + the iall tile 50,176 + the
    # flags 256 at the training shape; a second iall tile would pass the limit
    main = gru_seq_fwd_plan(GruDims(71, 128, 128, 5), 2, 4096)
    assert main.smem == 185_600
    assert main.smem + main.rows * (_r16(3 * 128) + PAD) * 2 > SMEM_MAX


@pytest.mark.parametrize("n_agents", AGENTS)
@pytest.mark.parametrize("widths", WIDTHS)
def test_blocks_fill_the_card_in_one_wave(widths, n_agents):
    for n_env in BANDS + [64, 1024, 8192]:
        plan = gru_seq_fwd_plan(GruDims(71, widths[0], widths[1], 5), n_agents, n_env)
        n_seq = n_env * n_agents
        wave = next((r for r in (16, 32, 64) if -(-n_seq // r) <= SWEEP_SMS), 64)
        assert plan.rows == wave, (widths, n_env)
    # the main shape: a 4,096-env band of tiny-2ag, one wave of 128 blocks; the
    # learning runs' 1,024-env bands; tiny-16ag's many blocks
    main = gru_seq_fwd_plan(GruDims(71, 128, 128, 5), 2, 4096)
    assert (main.rows, main.blocks) == (64, 128)
    assert gru_seq_fwd_plan(GruDims(71, 128, 128, 5), 2, 1024).rows == 16
    assert gru_seq_fwd_plan(GruDims(71, 128, 128, 5), 16, 4096).blocks == 1024


@pytest.mark.parametrize("widths", [(128, 256), (12, 128), (128, 20), (136, 8), (8, 136)])
def test_refuses_widths_the_kernel_does_not_take(widths):
    with pytest.raises(ValueError, match="multiples of 8 up to 128"):
        gru_seq_fwd_plan(GruDims(71, widths[0], widths[1], 5), 2, 4096)


def _emulate(plan, wh, bhn, iall, done, h0, start):
    """The kernel's data path in torch, block by block: the tile takes the
    block's run of band rows one step ahead, the warps take their columns out
    at the step's start, then h Wh and the cell into the other hidden buffer;
    hseq leaves a buffer at the next step's start, before its reset."""
    t_len, n_env, n, g3 = iall.shape
    hg, b = g3 // 3, done.shape[1]
    run = iall.reshape(t_len, -1, g3)  # band row t Q + q
    hseq = torch.empty((t_len, plan.n_seq, hg), dtype=torch.bfloat16)
    zero = torch.zeros((), dtype=torch.bfloat16)
    for tile in plan.tiles():
        q = torch.arange(tile.start, tile.stop)
        env = (start + q // n) % b
        k = len(tile)
        smem = torch.zeros((plan.rows, _r16(g3) + PAD), dtype=torch.bfloat16)

        def issue(t):
            smem[:k, :g3] = run[t, tile.start:tile.stop]
            smem[k:, :g3] = zero

        hs = [torch.zeros((plan.rows, hg)), torch.zeros((plan.rows, hg))]
        hs[0][:k] = h0[env, q % n].float()
        flags = torch.zeros(plan.rows, dtype=torch.bool)
        issue(0)
        for t in range(t_len):
            hc, hn = hs[t & 1], hs[(t + 1) & 1]
            if t > 0:
                hseq[t - 1, tile.start:tile.stop] = hc[:k].to(torch.bfloat16)
                hc[flags] = 0.0
            ia = torch.empty((plan.rows, g3))
            for w in range(hg // 8):  # warp w's units of each gate
                for gate in range(3):
                    cols = slice(gate * hg + 8 * w, gate * hg + 8 * w + 8)
                    ia[:, cols] = smem[:, cols].float()
            if t + 1 < t_len:
                issue(t + 1)  # lands during this step's h Wh
            flags = torch.zeros(plan.rows, dtype=torch.bool)
            flags[:k] = done[t, env]
            hn[:] = gru_replay_cell(wh, bhn, hc, ia)
        hseq[t_len - 1, tile.start:tile.stop] = hs[t_len & 1][:k].to(torch.bfloat16)
    return hseq.reshape(t_len, n_env, n, hg)


# (env id, (embed, hidden), envs, steps, band): the main widths, the padded ones,
# tiny-16ag's agents, 128 steps, tiles of 32 and 64; every band but one wraps
SPLIT_CASES = [
    ("rware-tiny-2ag-v2", (128, 128), 300, 4, (250, 100)),
    ("rware-tiny-2ag-v2", (24, 40), 300, 3, (290, 60)),
    ("rware-tiny-16ag-v2", (8, 8), 40, 3, (35, 10)),
    ("rware-tiny-2ag-v2", (8, 8), 20, 128, (15, 10)),
    ("rware-tiny-2ag-v2", (24, 40), 2048, 3, (1000, 1500)),
    ("rware-tiny-2ag-v2", (8, 8), 4096, 3, (0, 2113)),
]


@pytest.mark.parametrize("env_id,widths,b,t_len,band", SPLIT_CASES)
def test_the_data_path_gives_the_plain_k11s_bits(env_id, widths, b, t_len, band):
    dims, a = random_gru_seq_case(env_id, b, t_len, band, 3, hidden=widths[1], embed=widths[0])
    fwd = build_fused_gru_seq_fwd(dims)
    seq = (a["wh"], a["bhn"], a["iall"], a["done"], a["h0"])
    want = fwd.plain(*seq, *band)
    plan = gru_seq_fwd_plan(dims, a["h0"].shape[1], band[1])
    assert plan.rows == {100: 16, 60: 16, 10: 16, 1500: 32, 2113: 64}[band[1]]
    got = _emulate(plan, a["wh"].float(), a["bhn"].float(), *seq[2:], band[0])
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())
    assert fwd(*seq, *band).equal(want) and fwd.launches == 0  # the CPU wrapper is the plain one
