"""The GRU sequence kernels: the obs-fused forward (K9) and backward (K10),
and the iall-fed forward (K11), its backward (K12) and the loss-fused
backward (K13).

* :func:`build_fused_gru_obs_fwd` replaces
  ``rware_tpu/ops/pallas_gru.py::build_gru_obs_fwd``: the hidden sequence of
  the GRU over a stored trajectory, from the raw bf16 observations (embed and
  input gates are computed inside and never stored).
* :func:`build_fused_gru_obs_bwd` replaces ``build_gru_obs_bwd``: the reverse
  sweep from the hidden sequence's cotangent to the gradients of the embed and
  GRU weights and of the initial hidden.
* :class:`GruObsScan` joins the two as one differentiable function (the
  ``_gru_obs_scan`` custom VJP of ``rware_tpu/models/ippo_rnn.py:428-470``).

Both work on an **env band** of the full ``(T, B, N, ...)`` trajectory, read
in place: envs ``(start_env + i) % B`` for ``i < n_env``.  The JAX package
slices a doubled copy of its dataset for the same window; here nothing is
copied.  Outputs are band-local: ``hseq (T, n_env, N, Hg)``.

The iall-fed kernels take the fused input gates ``iall = bf16(e Wi + bi)``
(T, n_env, N, 3Hg) of the band, computed by the caller, and run only the
time recurrence:

* :func:`build_fused_gru_seq_fwd` (K11) replaces ``build_gru_seq_fwd``: the
  hidden sequence from iall;
* :func:`build_fused_gru_seq_bwd` (K12) replaces ``build_gru_seq_bwd``: from
  the hidden sequence's cotangent to (dWh, dbhn, d_iall, dh0);
* :func:`build_fused_gru_loss_bwd` (K13) replaces ``build_gru_loss_bwd``: the
  same backward with the f32 heads, the clipped-PPO loss and its backward
  inside;
* :class:`GruSeqScan` joins K11 and K12 as one differentiable function (the
  ``_gru_scan`` custom VJP of ``rware_tpu/models/ippo_rnn.py:272-405``, on
  the kernels of ``_gru_seq_kernels``).

K9 and K11 share one forward sweep (``csrc/gru_fwd_sweep.cuh``): every
product on the tensor cores, Wh and the hidden resident in shared memory.
K10, K12 and K13 are chains of kernels that share K10's reverse sweep
(``csrc/gru_bwd.cuh``) and weight-gradient pass.  Their launch plans
(:func:`gru_obs_fwd_plan`, :func:`gru_seq_fwd_plan`, :func:`gru_obs_bwd_plan`,
:func:`gru_seq_bwd_plan`) give tiles, grids, shared memory and scratch, and
the library refuses numbers that are not the plan's.

Each wrapper launches its CUDA kernel (``csrc/fused_gru_fwd.cu``,
``csrc/fused_gru_bwd.cu``, ``csrc/fused_gru_seq_fwd.cu``,
``csrc/fused_gru_seq_bwd.cu``, ``csrc/fused_gru_loss_bwd.cu``) for tensors on
a CUDA device and runs its plain PyTorch version (``.plain``) only for tensors
on the CPU; it counts its kernel launches in ``.launches``.  ``weights`` are the first six blocks of
:class:`~rware_tpu_torch.models.networks.GruDims`: ``We (L, E)``, ``be (1,
E)``, ``Wi (E, 3Hg)``, ``bi (1, 3Hg)``, ``Wh (Hg, 3Hg)``, ``bhn (1, Hg)``,
float32; the kernels round the matrices to bf16.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from rware_tpu_torch.models.networks import (
    GruDims,
    gru_replay_cell,
    gru_replay_step,
    rnd_bf16,
    sigmoid_f32,
    split_gates,
)

MAX_WIDTH = 128  # the kernels' embed and hidden widths: multiples of 8 up to this
# the card's SMs: the forward sweeps of K9 and K11 and the reverse sweep of
# K10, K12 and K13 take the lowest tile whose blocks fit them in one wave
SWEEP_SMS = 132
SMEM_MAX = 232_448  # bytes of shared memory one block may take on the H100


def band_index(start_env: int, n_env: int, b: int, device) -> torch.Tensor:
    """The trajectory envs of a band: ``(start_env + i) % b``."""
    return (start_env + torch.arange(n_env, device=device)) % b


def _check(dims: GruDims, weights, obs, done, h0, start_env, n_env):
    t_len, b, n, l_obs = obs.shape
    shapes = [tuple(w.shape) for w in weights]
    if shapes != [tuple(s) for s in dims.shapes[:6]]:
        raise ValueError(f"weights have shapes {shapes}, not {dims.shapes[:6]}")
    if l_obs != dims.obs_len or obs.dtype != torch.bfloat16:
        raise ValueError(f"obs must be bf16 (T, B, N, {dims.obs_len})")
    if tuple(done.shape) != (t_len, b) or done.dtype != torch.bool:
        raise ValueError(f"done must be bool {(t_len, b)}")
    if tuple(h0.shape) != (b, n, dims.hidden) or h0.dtype != torch.bfloat16:
        raise ValueError(f"h0 must be bf16 {(b, n, dims.hidden)}")
    if not 0 <= start_env < b or not 1 <= n_env <= b:
        raise ValueError(f"band ({start_env}, {n_env}) outside the {b} envs")
    devices = {x.device for x in (*weights, obs, done, h0)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    return devices.pop()


def _kernel_dims(dims: GruDims) -> None:
    if dims.embed % 8 or dims.hidden % 8 or max(dims.embed, dims.hidden) > MAX_WIDTH:
        raise ValueError(f"the GRU kernels take embed and hidden widths that are multiples of 8 "
                         f"up to {MAX_WIDTH}, not {dims.embed} and {dims.hidden}")


# K10's tiles (csrc/fused_gru_bwd.cu, csrc/gru_wgrad.cuh, csrc/gru_mma.cuh)
_PAD = 8  # bf16 columns added to each shared-memory row
_TILE, _KC, _SLICE = 64, 64, 16  # prologue / epilogue samples a block, k chunk, gate slice
# weight gradients: threads, samples a step, buffers, output tile
_WG_THREADS, _WG_SK, _WG_NS, _WG_TI, _WG_TJ = 512, 64, 3, 128, 128


_WGRAD_SMEM = 2 * _WG_NS * _WG_SK * ((_WG_TI + _PAD) + (_WG_TJ + _PAD)) + 4 * _WG_THREADS
# K12 and K13 (csrc/gru_seq_bwd.cuh): head columns A + 1 at most, head-gradient
# outputs (Hg + 1)(A + 1) at most, and prologue blocks at most (each takes a
# run of tiles, so that K13's per-block head partials stay few)
_HEADS, _HEAD_OUTS, _PRO_BLOCKS = 8, 1024, 8 * SWEEP_SMS


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def _sweep_rows(n_seq: int) -> int:
    """The reverse sweep's tile height: the smallest of 16, 32, 64 sequences
    whose blocks fit the card's SMs in one wave, else 64."""
    return next((r for r in (16, 32, 64) if -(-n_seq // r) <= SWEEP_SMS), 64)


def _sweep_smem(hg: int, rows: int, cot_floats: int = 0) -> int:
    """The sweep's shared memory (``csrc/gru_bwd.cuh::gb_sweep_smem``): Wh and
    the step's cotangent tile in bf16, the product's sums, the dbhn reduction
    and two ints a row, then ``cot_floats`` of the cotangent's own."""
    return (2 * (hg + rows) * (_r16(3 * hg) + _PAD) + 4 * (rows * (hg + 4) + 8 * hg) + 8 * rows
            + 4 * cot_floats)


def _fwd_stage(rows: int, l_obs: int) -> int:
    """Elements of K9's staging buffer: a step's obs rows of a block, as at
    most two runs of 16-byte chunks, each up to 14 elements past its rows."""
    return -(-(rows * l_obs + 32) // 8) * 8


def _fwd_smem(l_obs: int, e: int, hg: int, rows: int) -> int:
    """K9's shared memory (``csrc/fused_gru_fwd.cu::gf_layout``): Wh, two
    hidden tiles, the embedding and obs tiles, the staging buffer and the
    weight ring (two slots of 16 rows of We or Wi) in bf16, then an int a
    row."""
    lde, ldh, ldx = _r16(e) + _PAD, _r16(hg) + _PAD, _r16(l_obs) + _PAD
    ldw = _r16(3 * hg) + _PAD
    elems = (_r16(hg) * ldw + rows * (2 * ldh + lde + ldx) + _fwd_stage(rows, l_obs)
             + 2 * 16 * max(ldw, lde))
    return 2 * elems + 4 * rows


@dataclasses.dataclass(frozen=True)
class GruFwdPlan:
    """K9's launch shape for one band: ``n_seq = n_env N`` sequences in
    blocks of ``rows``."""

    n_seq: int
    n_agents: int
    rows: int  # sequences a block: 16, 32 or 64
    blocks: int
    smem: int  # dynamic shared memory of a block, bytes
    stage: int  # elements of a block's obs staging buffer

    def tiles(self) -> List[range]:
        """The sequences of each block."""
        return _ranges(self.rows, self.n_seq, self.blocks)

    def obs_runs(self, block: int, start_env: int, b: int) -> List[Tuple[int, int]]:
        """(first row, rows) of the runs of a step's trajectory rows (env *
        N + agent) that block ``block`` reads for a band starting at
        ``start_env`` of ``b`` envs: one, or two where the band wraps
        (``csrc/fused_gru_fwd.cu::gf_runs``)."""
        bn, q0 = b * self.n_agents, block * self.rows
        r1 = (start_env * self.n_agents + q0) % bn
        n_rows = min(self.rows, self.n_seq - q0)
        n1 = min(n_rows, bn - r1)
        return [(r1, n1)] + ([(0, n_rows - n1)] if n_rows > n1 else [])


def gru_obs_fwd_plan(dims: GruDims, n_agents: int, n_env: int) -> GruFwdPlan:
    """K9's launch plan for a band of ``n_env`` envs: blocks of the smallest of
    16, 32, 64 sequences whose blocks fit the card's SMs in one wave (else
    64), halved while a block's shared memory would pass ``SMEM_MAX`` (long
    observation rows).  The library refuses other numbers.  Raises
    ``ValueError`` for widths the kernel does not take."""
    _kernel_dims(dims)
    n_seq = n_env * n_agents
    fits = [r for r in (16, 32, 64) if r <= _sweep_rows(n_seq)
            and _fwd_smem(dims.obs_len, dims.embed, dims.hidden, r) <= SMEM_MAX]
    if not fits:
        raise ValueError(f"observations of {dims.obs_len} are too long for the GRU forward "
                         "kernel's shared memory")
    rows = fits[-1]
    return GruFwdPlan(n_seq, n_agents, rows, -(-n_seq // rows),
                      _fwd_smem(dims.obs_len, dims.embed, dims.hidden, rows),
                      _fwd_stage(rows, dims.obs_len))


def _seq_fwd_smem(hg: int, rows: int) -> int:
    """K11's shared memory (``csrc/fused_gru_seq_fwd.cu::gs_layout``): Wh,
    two hidden tiles and the step's iall tile in bf16, then an int a row."""
    ldw, ldh = _r16(3 * hg) + _PAD, _r16(hg) + _PAD
    return 2 * (_r16(hg) * ldw + rows * (2 * ldh + ldw)) + 4 * rows


@dataclasses.dataclass(frozen=True)
class GruSeqFwdPlan:
    """K11's launch shape for one band: ``n_seq = n_env N`` sequences in
    blocks of ``rows``."""

    n_seq: int
    rows: int  # sequences a block: 16, 32 or 64
    blocks: int
    smem: int  # dynamic shared memory of a block, bytes

    def tiles(self) -> List[range]:
        """The sequences of each block."""
        return _ranges(self.rows, self.n_seq, self.blocks)


def gru_seq_fwd_plan(dims: GruDims, n_agents: int, n_env: int) -> GruSeqFwdPlan:
    """K11's launch plan for a band of ``n_env`` envs: blocks of the smallest
    of 16, 32, 64 sequences whose blocks fit the card's SMs in one wave (else
    64), and their shared memory; the library refuses other numbers.  Raises
    ``ValueError`` for widths the kernel does not take."""
    _kernel_dims(dims)
    n_seq = n_env * n_agents
    rows = _sweep_rows(n_seq)
    return GruSeqFwdPlan(n_seq, rows, -(-n_seq // rows), _seq_fwd_smem(dims.hidden, rows))


def _wgrad_chunks(n_samples: int) -> Tuple[int, int]:
    """(chunk, n_chunks): up to 128 weight-gradient partials, each over a
    multiple of 64 samples."""
    n_chunks = min(128, -(-n_samples // 1024))
    return _WG_SK * -(-n_samples // (_WG_SK * n_chunks)), n_chunks


def _ranges(size: int, total: int, count: int) -> List[range]:
    """``count`` consecutive runs of ``size`` out of ``range(total)``, the last
    cut at ``total``."""
    return [range(b * size, min((b + 1) * size, total)) for b in range(count)]


@dataclasses.dataclass(frozen=True)
class GruBwdPlan:
    """K10's launch shape for one band: ``n_seq = n_env N`` sequences,
    ``n_samples = T n_seq`` sequence-steps (row ``t n_seq + q``)."""

    n_seq: int
    n_samples: int
    sweep_rows: int  # sequences a sweep block: 16, 32 or 64
    sweep_blocks: int
    tile_blocks: int  # prologue and epilogue blocks, 64 samples each
    smem: Dict[str, int]  # dynamic shared memory of each kernel, bytes
    chunk: int  # samples a weight-gradient partial
    n_chunks: int
    scratch: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]

    def sweep_tiles(self) -> List[range]:
        """The sequences of each sweep block."""
        return _ranges(self.sweep_rows, self.n_seq, self.sweep_blocks)

    def sample_tiles(self) -> List[range]:
        """The samples of each prologue and epilogue block."""
        return _ranges(_TILE, self.n_samples, self.tile_blocks)

    def chunks(self) -> List[range]:
        """The samples of each weight-gradient partial."""
        return _ranges(self.chunk, self.n_samples, self.n_chunks)


def gru_obs_bwd_plan(dims: GruDims, t_len: int, n_agents: int, n_env: int) -> GruBwdPlan:
    """K10's launch plan for a band of ``n_env`` envs: the sweep's tile height
    (the smallest of 16, 32, 64 sequences whose blocks fit the card's SMs in
    one wave, else 64), the grids, each kernel's shared memory (the library
    refuses other numbers), the weight-gradient chunks and the scratch.
    Raises ``ValueError`` for widths the kernels do not take."""
    _kernel_dims(dims)
    e, hg = dims.embed, dims.hidden
    n_seq = n_env * n_agents
    n_samples = t_len * n_seq
    rows = _sweep_rows(n_seq)
    e16, h16 = _r16(e), _r16(hg)
    tiles = _TILE * (e16 + _PAD) + _TILE * (h16 + _PAD)
    embed = 2 * (_TILE * (_KC + _PAD) + _KC * (e16 + _PAD))
    gates = 2 * (e16 + h16) * (3 * _SLICE + _PAD)
    smem = {
        "prologue": 2 * (tiles + max(embed, gates)) + 20 * _TILE,
        "sweep": _sweep_smem(hg, rows),
        "epilogue": 2 * 2 * (_TILE + e) * (_KC + _PAD),
        "wgrad": _WGRAD_SMEM,
    }
    chunk, n_chunks = _wgrad_chunks(n_samples)
    sweep_blocks = -(-n_seq // rows)
    n_w = sum(r * c for r, c in dims.shapes[:5])
    bf, f32 = torch.bfloat16, torch.float32
    scratch = {
        "e": ((n_samples, e), bf), "rz": ((n_samples, 2 * hg), f32),
        "hn": ((n_samples, 2 * hg), bf), "dg4": ((n_samples, 4 * hg), bf),
        "dpre": ((n_samples, e), bf), "part_bhn": ((sweep_blocks, hg), f32),
        "partial": ((n_chunks, n_w), f32),
    }
    return GruBwdPlan(n_seq, n_samples, rows, sweep_blocks, -(-n_samples // _TILE), smem, chunk,
                      n_chunks, scratch)


@dataclasses.dataclass(frozen=True)
class GruSeqBwdPlan:
    """K12's or K13's launch shape for one band: ``n_seq = n_env N``
    sequences, ``n_samples = T n_seq`` sequence-steps (row ``t n_seq
    + q``) in ``n_tiles`` tiles of 64; prologue block ``b`` takes the tiles
    ``b tiles_per_block ..`` and, for K13, sums their head gradients and
    metrics into its own row of ``n_head`` floats."""

    n_seq: int
    n_samples: int
    sweep_rows: int  # sequences a sweep block: 16, 32 or 64
    sweep_blocks: int
    n_tiles: int
    tiles_per_block: int
    prologue_blocks: int
    smem: Dict[str, int]  # dynamic shared memory of each kernel, bytes
    chunk: int  # samples a dWh partial
    n_chunks: int
    n_head: int  # K13: (Hg + 1)(A + 1) + 4 entries of a prologue block's partial; K12: 0
    scratch: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]

    @property
    def args(self) -> Tuple[int, ...]:
        """The numbers the library takes, and checks against its own."""
        return (self.sweep_rows, self.tiles_per_block, self.smem["prologue"], self.smem["sweep"],
                self.smem["wgrad"], self.chunk, self.n_chunks)

    def sweep_tiles(self) -> List[range]:
        """The sequences of each sweep block."""
        return _ranges(self.sweep_rows, self.n_seq, self.sweep_blocks)

    def sample_tiles(self) -> List[range]:
        """The samples of each prologue tile."""
        return _ranges(_TILE, self.n_samples, self.n_tiles)

    def prologue_tiles(self) -> List[range]:
        """The tiles of each prologue block, in the order it takes them."""
        return _ranges(self.tiles_per_block, self.n_tiles, self.prologue_blocks)

    def chunks(self) -> List[range]:
        """The samples of each dWh partial."""
        return _ranges(self.chunk, self.n_samples, self.n_chunks)


def gru_seq_bwd_plan(dims: GruDims, t_len: int, n_agents: int, n_env: int,
                     loss: bool) -> GruSeqBwdPlan:
    """K12's or K13's launch plan for a band of ``n_env`` envs: the sweep's
    tile height (as K10's), the prologue's tiles and blocks, each kernel's
    shared memory (the library refuses other numbers), the dWh chunks and the
    scratch (``csrc/gru_seq_bwd.cuh::gsq_bwd_run``).  Raises ``ValueError``
    for widths the kernels do not take: hidden a multiple of 8 up to 128, and
    for K13 1 to 7 actions with (hidden + 1)(actions + 1) <= 1024."""
    _kernel_dims(dims)
    hg, a1 = dims.hidden, dims.n_actions + 1
    if loss and not (2 <= a1 <= _HEADS and (hg + 1) * a1 <= _HEAD_OUTS):
        raise ValueError(f"the loss-fused GRU backward takes 1 to {_HEADS - 1} actions with "
                         f"(hidden + 1)(actions + 1) <= {_HEAD_OUTS}, not {dims.n_actions} "
                         f"actions at hidden {hg}")
    n_seq = n_env * n_agents
    n_samples = t_len * n_seq
    rows = _sweep_rows(n_seq)
    n_tiles = -(-n_samples // _TILE)
    tiles_per_block = -(-n_tiles // _PRO_BLOCKS)
    prologue_blocks = -(-n_tiles // tiles_per_block)
    h16 = _r16(hg)
    tiles = (2 if loss else 1) * _TILE * (h16 + _PAD) + 2 * (h16 + _TILE) * (3 * _SLICE + _PAD)
    heads = (hg + 1) * _HEADS + _TILE * _HEADS + _TILE * 4 if loss else 0
    smem = {
        "prologue": 2 * tiles + 4 * heads + 12 * _TILE,
        "sweep": _sweep_smem(hg, rows, _HEADS * MAX_WIDTH if loss else 0),
        "wgrad": _WGRAD_SMEM,
    }
    chunk, n_chunks = _wgrad_chunks(n_samples)
    sweep_blocks = -(-n_seq // rows)
    n_head = (hg + 1) * a1 + 4 if loss else 0
    bf, f32 = torch.bfloat16, torch.float32
    scratch = {"rz": ((n_samples, 2 * hg), f32), "hn": ((n_samples, 2 * hg), bf),
               "dhhn": ((n_samples, hg), bf)}
    if loss:
        scratch["dheads"] = ((n_samples, _HEADS), f32)
    scratch["part_bhn"] = ((sweep_blocks, hg), f32)
    if loss:
        scratch["part_head"] = ((prologue_blocks, n_head), f32)
    scratch["partial"] = ((n_chunks, hg * 3 * hg), f32)
    return GruSeqBwdPlan(n_seq, n_samples, rows, sweep_blocks, n_tiles, tiles_per_block,
                         prologue_blocks, smem, chunk, n_chunks, n_head, scratch)


def _workspace(cache: Dict[Tuple, Dict[str, torch.Tensor]], dev, plan) -> Dict[str, torch.Tensor]:
    """A plan's scratch on ``dev``, kept in ``cache`` for the next launch of
    the same shapes (one shape at a time: the buffers are large)."""
    key = (dev,) + tuple(shape for shape, _ in plan.scratch.values())
    if key not in cache:
        cache.clear()
        cache[key] = {name: torch.empty(shape, dtype=dtype, device=dev)
                      for name, (shape, dtype) in plan.scratch.items()}
    return cache[key]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to(torch.bfloat16).contiguous()


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to(torch.float32).contiguous()


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous, its data at a 16-byte boundary (a copy where a view
    starts elsewhere)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


class FusedGruObsFwd:
    """``fwd(weights, obs, done, h0, start_env, n_env) -> hseq``; see
    :func:`build_fused_gru_obs_fwd`."""

    def __init__(self, dims: GruDims):
        self.dims = dims
        self.launches = 0

    def __call__(self, weights: Sequence[torch.Tensor], obs, done, h0, start_env: int,
                 n_env: int) -> torch.Tensor:
        dev = _check(self.dims, weights, obs, done, h0, start_env, n_env)
        if dev.type == "cuda":
            return self._launch(weights, obs, done, h0, start_env, n_env)
        if dev.type == "cpu":
            return self.plain(weights, obs, done, h0, start_env, n_env)
        raise ValueError(f"no GRU forward kernel for device {dev}")

    @torch.no_grad()
    def plain(self, weights, obs, done, h0, start_env: int, n_env: int) -> torch.Tensor:
        """The plain PyTorch version: T steps of
        :func:`~rware_tpu_torch.models.networks.gru_replay_step`, the hidden
        zeroed after a step where ``done``."""
        _check(self.dims, weights, obs, done, h0, start_env, n_env)
        idx = band_index(start_env, n_env, obs.shape[1], obs.device)
        weights = [w.detach().float() for w in weights]
        h = h0[idx].float()
        out = []
        for t in range(obs.shape[0]):
            new_h = gru_replay_step(weights, h, obs[t, idx])
            out.append(new_h.to(torch.bfloat16))
            h = torch.where(done[t, idx][:, None, None], torch.zeros_like(new_h), new_h)
        return torch.stack(out)

    @torch.no_grad()
    def _launch(self, weights, obs, done, h0, start_env, n_env):
        from rware_tpu_torch.ops._build import check, load_library

        dev = obs.device
        t_len, b, n, l_obs = obs.shape
        plan = gru_obs_fwd_plan(self.dims, n, n_env)
        lib = load_library()
        we, be, wi, bi, wh, bhn = weights
        with torch.cuda.device(dev):
            args = [obs.contiguous(), done.contiguous(), h0.contiguous(), _bf16(we), _f32(be),
                    _bf16(wi), _f32(bi), _bf16(wh), _f32(bhn)]
            hseq = torch.empty((t_len, n_env, n, self.dims.hidden), dtype=torch.bfloat16,
                               device=dev)
            code = lib.rw_fused_gru_fwd(
                l_obs, self.dims.embed, self.dims.hidden, t_len, b, n, start_env, n_env,
                plan.rows, plan.smem, *[a.data_ptr() for a in args], hseq.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            check(lib, code, "fused_gru_fwd")
            self.launches += 1
        return hseq


class FusedGruObsBwd:
    """``bwd(weights, obs, done, h0, hseq, dhseq, start_env, n_env) -> (grads,
    dh0)``; see :func:`build_fused_gru_obs_bwd`."""

    def __init__(self, dims: GruDims):
        self.dims = dims
        self.launches = 0
        self._scratch: Dict[Tuple, Dict[str, torch.Tensor]] = {}

    @property
    def n_grads(self) -> int:
        return sum(r * c for r, c in self.dims.shapes[:6])

    def split(self, grads: torch.Tensor):
        """``grads`` as (dWe, dbe, dWi, dbi, dWh, dbhn), views in the shapes of
        ``weights``."""
        shapes = self.dims.shapes[:6]
        return [g.view(s) for g, s in zip(torch.split(grads, [r * c for r, c in shapes]), shapes)]

    def _check(self, weights, obs, done, h0, hseq, dhseq, start_env, n_env):
        dev = _check(self.dims, weights, obs, done, h0, start_env, n_env)
        want = (obs.shape[0], n_env, obs.shape[2], self.dims.hidden)
        for name, x in (("hseq", hseq), ("dhseq", dhseq)):
            if tuple(x.shape) != want or x.dtype != torch.bfloat16 or x.device != dev:
                raise ValueError(f"{name} must be bf16 {want} on {dev}")
        return dev

    def __call__(self, weights, obs, done, h0, hseq, dhseq, start_env: int, n_env: int):
        dev = self._check(weights, obs, done, h0, hseq, dhseq, start_env, n_env)
        if dev.type == "cuda":
            return self._launch(weights, obs, done, h0, hseq, dhseq, start_env, n_env)
        if dev.type == "cpu":
            return self.plain(weights, obs, done, h0, hseq, dhseq, start_env, n_env)
        raise ValueError(f"no GRU backward kernel for device {dev}")

    @torch.no_grad()
    def plain(self, weights, obs, done, h0, hseq, dhseq, start_env: int, n_env: int):
        """The plain PyTorch version: the reverse sweep of
        ``pallas_gru.py:645-726`` step by step, with its roundings: r and z
        stay float32 in the derivatives, the cotangents are rounded to bf16
        before every product, ``dbhn`` sums the unrounded ``dhhn``."""
        self._check(weights, obs, done, h0, hseq, dhseq, start_env, n_env)
        idx = band_index(start_env, n_env, obs.shape[1], obs.device)
        we, be, wi, bi, wh, bhn = (w.detach().float() for w in weights)
        web, wib, whb = rnd_bf16(we), rnd_bf16(wi), rnd_bf16(wh)
        hg = self.dims.hidden
        grads = [torch.zeros_like(w) for w in (we, be, wi, bi, wh, bhn)]
        dwe, dbe, dwi, dbi, dwh, dbhn = grads
        dc = torch.zeros((n_env, obs.shape[2], hg), dtype=torch.float32, device=obs.device)
        for t in range(obs.shape[0] - 1, -1, -1):
            x = obs[t, idx].float()
            e = rnd_bf16(torch.tanh(rnd_bf16(x @ web + be[0])))
            ia_r, ia_z, ia_n = split_gates(rnd_bf16(e @ wib + bi[0]))
            if t == 0:
                hp = h0[idx].float()
            else:
                hp = torch.where(done[t - 1, idx][:, None, None], 0.0, hseq[t - 1].float())
            hh_r, hh_z, hh_n = split_gates(hp @ whb)
            r, z = sigmoid_f32(ia_r + hh_r), sigmoid_f32(ia_z + hh_z)
            hhn = rnd_bf16(hh_n + bhn[0])
            nn = rnd_bf16(torch.tanh(rnd_bf16(ia_n + rnd_bf16(rnd_bf16(r) * hhn))))
            dnh = dhseq[t].float() + torch.where(done[t, idx][:, None, None], 0.0, dc)
            dz_pre = dnh * (hp - nn) * z * (1.0 - z)
            dn_pre = dnh * (1.0 - z) * (1.0 - nn * nn)
            dhhn = dn_pre * r
            dr_pre = dn_pre * hhn * r * (1.0 - r)
            dg3 = rnd_bf16(torch.cat([dr_pre, dz_pre, dhhn], -1)).reshape(-1, 3 * hg)
            dgi = rnd_bf16(torch.cat([dr_pre, dz_pre, dn_pre], -1)).reshape(-1, 3 * hg)
            dc = dnh * z + (dg3 @ whb.t()).reshape(dnh.shape)
            dwh += hp.reshape(-1, hg).t() @ dg3
            dbhn += dhhn.reshape(-1, hg).sum(0, keepdim=True)
            e2 = e.reshape(-1, e.shape[-1])
            dwi += e2.t() @ dgi
            dbi += dgi.sum(0, keepdim=True)
            dpre = rnd_bf16((dgi @ wib.t()) * (1.0 - e2 * e2))
            dwe += x.reshape(-1, x.shape[-1]).t() @ dpre
            dbe += dpre.sum(0, keepdim=True)
        return torch.cat([g.reshape(-1) for g in grads]), dc

    def timed(self, weights, obs, done, h0, hseq, dhseq, start_env: int, n_env: int):
        """One launch on the card that waits for its kernels and returns
        ``(grads, dh0, ms)``: ``ms`` the milliseconds of the prologue, the
        sweep, the epilogue and the weight gradients, by CUDA events."""
        dev = self._check(weights, obs, done, h0, hseq, dhseq, start_env, n_env)
        if dev.type != "cuda":
            raise ValueError("the time split is taken on the card")
        split = (ctypes.c_float * 4)()
        grads, dh0 = self._launch(weights, obs, done, h0, hseq, dhseq, start_env, n_env, split)
        return grads, dh0, dict(zip(("prologue", "sweep", "epilogue", "wgrad"), split))

    @torch.no_grad()
    def _launch(self, weights, obs, done, h0, hseq, dhseq, start_env, n_env, split=None):
        from rware_tpu_torch.ops._build import check, load_library

        dev = obs.device
        t_len, b, n, l_obs = obs.shape
        plan = gru_obs_bwd_plan(self.dims, t_len, n, n_env)
        lib = load_library()
        we, be, wi, bi, wh, bhn = weights
        with torch.cuda.device(dev):
            ws = _workspace(self._scratch, dev, plan)
            args = [obs.contiguous(), done.contiguous(), h0.contiguous(), hseq.contiguous(),
                    dhseq.contiguous(), _bf16(we), _f32(be), _bf16(wi), _f32(bi), _bf16(wh),
                    _f32(bhn)] + [ws[k] for k in plan.scratch]
            grads = torch.empty(self.n_grads, dtype=torch.float32, device=dev)
            dh0 = torch.empty((n_env, n, self.dims.hidden), dtype=torch.float32, device=dev)
            sm = plan.smem
            code = lib.rw_fused_gru_bwd(
                l_obs, self.dims.embed, self.dims.hidden, t_len, b, n, start_env, n_env,
                plan.sweep_rows, sm["prologue"], sm["sweep"], sm["epilogue"], sm["wgrad"],
                plan.chunk, plan.n_chunks, *[a.data_ptr() for a in args], grads.data_ptr(),
                dh0.data_ptr(), split, torch.cuda.current_stream(dev).cuda_stream)
            check(lib, code, "fused_gru_bwd")
            self.launches += 1
        return grads, dh0


def build_fused_gru_obs_fwd(dims: GruDims) -> FusedGruObsFwd:
    """Returns ``fwd(weights, obs, done, h0, start_env, n_env) -> hseq``:
    ``obs`` (T, B, N, L) bf16, ``done`` (T, B) bool and ``h0`` (B, N, Hg) bf16
    are the whole trajectory and the carry at its start; ``hseq`` (T, n_env,
    N, Hg) bf16 is the band's hidden after each step, BEFORE the reset where
    ``done`` (``pallas_gru.py:385-404``)."""
    return FusedGruObsFwd(dims)


def build_fused_gru_obs_bwd(dims: GruDims) -> FusedGruObsBwd:
    """Returns ``bwd(weights, obs, done, h0, hseq, dhseq, start_env, n_env) ->
    (grads, dh0)``: ``grads`` is one flat float32 vector of (dWe, dbe, dWi,
    dbi, dWh, dbhn) (:meth:`FusedGruObsBwd.split`), ``dh0`` (n_env, N, Hg)
    float32 (``pallas_gru.py:547-568``).  Two launches give the same bits."""
    return FusedGruObsBwd(dims)


class GruObsScan(torch.autograd.Function):
    """``hseq = GruObsScan.apply(We, be, Wi, bi, Wh, bhn, obs, done, h0,
    start_env, n_env, fwd, bwd)``: the forward is ``fwd`` (K9) and the
    backward ``bwd`` (K10), as ``_gru_obs_scan`` of the JAX package.  ``Wh``
    enters that function in bf16 (``ippo_rnn.py:504-511``), so its gradient
    is rounded to bf16; the others stay float32.  ``obs``, ``done`` and ``h0``
    get no gradient."""

    @staticmethod
    def forward(ctx, we, be, wi, bi, wh, bhn, obs, done, h0, start_env, n_env, fwd, bwd):
        hseq = fwd((we, be, wi, bi, wh, bhn), obs, done, h0, start_env, n_env)
        ctx.save_for_backward(we, be, wi, bi, wh, bhn, obs, done, h0, hseq)
        ctx.band, ctx.bwd = (start_env, n_env), bwd
        return hseq

    @staticmethod
    def backward(ctx, dhseq):
        *weights, obs, done, h0, hseq = ctx.saved_tensors
        grads, _ = ctx.bwd(weights, obs, done, h0, hseq, dhseq.to(torch.bfloat16).contiguous(),
                           *ctx.band)
        dwe, dbe, dwi, dbi, dwh, dbhn = ctx.bwd.split(grads)
        return (dwe, dbe, dwi, dbi, rnd_bf16(dwh), dbhn) + (None,) * 7


def _check_seq(dims: GruDims, wh, bhn, iall, done, h0, start_env: int, n_env: int):
    """The device of an iall-fed call; raises on shapes, types or a band the
    kernels do not take."""
    hg = dims.hidden
    if tuple(wh.shape) != (hg, 3 * hg) or tuple(bhn.shape) != (1, hg):
        raise ValueError(f"wh and bhn must be ({hg}, {3 * hg}) and (1, {hg})")
    if iall.dim() != 4 or iall.dtype != torch.bfloat16 or iall.shape[1] != n_env \
            or iall.shape[3] != 3 * hg:
        raise ValueError(f"iall must be bf16 (T, {n_env}, N, {3 * hg})")
    t_len, _, n, _ = iall.shape
    if done.dim() != 2 or done.shape[0] != t_len or done.dtype != torch.bool:
        raise ValueError(f"done must be bool ({t_len}, B)")
    b = done.shape[1]
    if tuple(h0.shape) != (b, n, hg) or h0.dtype != torch.bfloat16:
        raise ValueError(f"h0 must be bf16 {(b, n, hg)}")
    if not 0 <= start_env < b or not 1 <= n_env <= b:
        raise ValueError(f"band ({start_env}, {n_env}) outside the {b} envs")
    devices = {x.device for x in (wh, bhn, iall, done, h0)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    return devices.pop()


def _check_band_seq(name: str, x: torch.Tensor, iall: torch.Tensor, hg: int, dev) -> None:
    want = tuple(iall.shape[:3]) + (hg,)
    if tuple(x.shape) != want or x.dtype != torch.bfloat16 or x.device != dev:
        raise ValueError(f"{name} must be bf16 {want} on {dev}")


def _seq_bwd_plain(wh, bhn, iall, done, h0, hseq, dh_out, idx):
    """The reverse sweep of K12 and K13 step by step (``pallas_gru.py:224-268``
    = ``:955-1003``): ``dh_out`` (T, n_env, N, Hg) float32 is the cotangent
    that reaches each step's hidden from outside the recurrence.  r and z stay
    float32, the candidate is recomputed in bf16, ``[dr | dz | dhhn]`` is
    rounded to bf16 before the Wh products, ``dbhn`` sums the unrounded
    ``dhhn``.  Returns (dWh, dbhn (1, Hg), d_iall bf16, dh0 float32)."""
    whb, bhn = rnd_bf16(wh.detach().float()), bhn.detach().float()
    hg = whb.shape[0]
    dwh = torch.zeros_like(whb)
    dbhn = torch.zeros_like(bhn)
    d_iall = torch.empty_like(iall)
    dc = torch.zeros(iall.shape[1:3] + (hg,), dtype=torch.float32, device=iall.device)
    for t in range(iall.shape[0] - 1, -1, -1):
        ia_r, ia_z, ia_n = split_gates(iall[t].float())
        if t == 0:
            hp = h0[idx].float()
        else:
            hp = torch.where(done[t - 1, idx][:, None, None], 0.0, hseq[t - 1].float())
        hh_r, hh_z, hh_n = split_gates(hp @ whb)
        r, z = sigmoid_f32(ia_r + hh_r), sigmoid_f32(ia_z + hh_z)
        hhn = rnd_bf16(hh_n + bhn[0])
        nn = rnd_bf16(torch.tanh(rnd_bf16(ia_n + rnd_bf16(rnd_bf16(r) * hhn))))
        dnh = dh_out[t] + torch.where(done[t, idx][:, None, None], 0.0, dc)
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


class FusedGruSeqFwd:
    """``fwd(wh, bhn, iall, done, h0, start_env, n_env) -> hseq``; see
    :func:`build_fused_gru_seq_fwd`."""

    def __init__(self, dims: GruDims):
        self.dims = dims
        self.launches = 0

    def __call__(self, wh, bhn, iall, done, h0, start_env: int, n_env: int) -> torch.Tensor:
        dev = _check_seq(self.dims, wh, bhn, iall, done, h0, start_env, n_env)
        if dev.type == "cuda":
            return self._launch(wh, bhn, iall, done, h0, start_env, n_env)
        if dev.type == "cpu":
            return self.plain(wh, bhn, iall, done, h0, start_env, n_env)
        raise ValueError(f"no GRU sequence forward kernel for device {dev}")

    @torch.no_grad()
    def plain(self, wh, bhn, iall, done, h0, start_env: int, n_env: int) -> torch.Tensor:
        """The plain PyTorch version: T steps of
        :func:`~rware_tpu_torch.models.networks.gru_replay_cell`, the hidden
        zeroed after a step where ``done``."""
        _check_seq(self.dims, wh, bhn, iall, done, h0, start_env, n_env)
        idx = band_index(start_env, n_env, done.shape[1], iall.device)
        wh, bhn = wh.detach().float(), bhn.detach().float()
        h = h0[idx].float()
        out = []
        for t in range(iall.shape[0]):
            new_h = gru_replay_cell(wh, bhn, h, iall[t].float())
            out.append(new_h.to(torch.bfloat16))
            h = torch.where(done[t, idx][:, None, None], torch.zeros_like(new_h), new_h)
        return torch.stack(out)

    @torch.no_grad()
    def _launch(self, wh, bhn, iall, done, h0, start_env, n_env):
        from rware_tpu_torch.ops._build import check, load_library

        dev = iall.device
        t_len, _, n, _ = iall.shape
        plan = gru_seq_fwd_plan(self.dims, n, n_env)
        lib = load_library()
        with torch.cuda.device(dev):
            # the kernel copies iall and h0 in 16-byte chunks
            args = [_aligned(iall), done.contiguous(), _aligned(h0), _bf16(wh), _f32(bhn)]
            hseq = torch.empty((t_len, n_env, n, self.dims.hidden), dtype=torch.bfloat16,
                               device=dev)
            code = lib.rw_fused_gru_seq_fwd(
                self.dims.hidden, t_len, done.shape[1], n, start_env, n_env, plan.rows,
                plan.smem, *[a.data_ptr() for a in args], hseq.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            check(lib, code, "fused_gru_seq_fwd")
            self.launches += 1
        return hseq


class _SeqBwdLaunch:
    """The launch of K12 and K13 (``csrc/gru_seq_bwd.cuh``) on
    :func:`gru_seq_bwd_plan`, its scratch kept between launches."""

    loss = False

    def __init__(self, dims: GruDims):
        self.dims = dims
        self.launches = 0
        self._scratch: Dict[Tuple, Dict[str, torch.Tensor]] = {}

    def _run(self, name: str, ints, scalars, tensors, iall, done, start_env: int, n_env: int,
             split):
        """One launch of ``rw_<name>(Hg, *ints, T, B, N, start_env, n_env,
        *plan.args, *scalars, *tensors, *scratch, d_iall, grads, dh0, split_ms,
        stream)``; returns (flat grads, d_iall, dh0)."""
        from rware_tpu_torch.ops._build import check, load_library

        dev = iall.device
        t_len, _, n, _ = iall.shape
        plan = gru_seq_bwd_plan(self.dims, t_len, n, n_env, self.loss)
        lib = load_library()
        hg = self.dims.hidden
        with torch.cuda.device(dev):
            ws = _workspace(self._scratch, dev, plan)
            d_iall = torch.empty(iall.shape, dtype=torch.bfloat16, device=dev)
            grads = torch.empty(hg * 3 * hg + hg + plan.n_head, dtype=torch.float32, device=dev)
            dh0 = torch.empty((n_env, n, hg), dtype=torch.float32, device=dev)
            code = getattr(lib, f"rw_{name}")(
                hg, *ints, t_len, done.shape[1], n, start_env, n_env, *plan.args, *scalars,
                *[x.data_ptr() for x in tensors], *[ws[k].data_ptr() for k in plan.scratch],
                d_iall.data_ptr(), grads.data_ptr(), dh0.data_ptr(), split,
                torch.cuda.current_stream(dev).cuda_stream)
            check(lib, code, name)
            self.launches += 1
        return grads, d_iall, dh0

    def timed(self, *args):
        """One launch on the card that waits for its kernels and returns
        ``(out, ms)``: ``out`` what the call returns, ``ms`` the milliseconds
        of the prologue, the sweep, dWh and the reduction, by CUDA events."""
        dev = self._check(*args)
        if dev.type != "cuda":
            raise ValueError("the time split is taken on the card")
        split = (ctypes.c_float * 4)()
        out = self._launch(*args, split=split)
        return out, dict(zip(("prologue", "sweep", "wgrad", "reduce"), split))

    @staticmethod
    def _weights(wh, bhn):
        return [_bf16(wh), _f32(bhn)]


class FusedGruSeqBwd(_SeqBwdLaunch):
    """``bwd(wh, bhn, iall, done, h0, hseq, dhseq, start_env, n_env) -> (dwh,
    dbhn, d_iall, dh0)``; see :func:`build_fused_gru_seq_bwd`.  Besides each
    wrapper's ``.launches``, ``FusedGruSeqBwd.all_launches`` counts the
    launches of every wrapper, so that a run can show how often any caller
    (e.g. :class:`GruSeqScan`) reached K12."""

    all_launches = 0

    def _check(self, wh, bhn, iall, done, h0, hseq, dhseq, start_env, n_env):
        dev = _check_seq(self.dims, wh, bhn, iall, done, h0, start_env, n_env)
        for name, x in (("hseq", hseq), ("dhseq", dhseq)):
            _check_band_seq(name, x, iall, self.dims.hidden, dev)
        return dev

    def __call__(self, wh, bhn, iall, done, h0, hseq, dhseq, start_env: int, n_env: int):
        dev = self._check(wh, bhn, iall, done, h0, hseq, dhseq, start_env, n_env)
        if dev.type == "cuda":
            return self._launch(wh, bhn, iall, done, h0, hseq, dhseq, start_env, n_env)
        if dev.type == "cpu":
            return self.plain(wh, bhn, iall, done, h0, hseq, dhseq, start_env, n_env)
        raise ValueError(f"no GRU sequence backward kernel for device {dev}")

    @torch.no_grad()
    def plain(self, wh, bhn, iall, done, h0, hseq, dhseq, start_env: int, n_env: int):
        """The plain PyTorch version: the reverse sweep of
        ``pallas_gru.py:224-268`` step by step, from ``dhseq``."""
        self._check(wh, bhn, iall, done, h0, hseq, dhseq, start_env, n_env)
        idx = band_index(start_env, n_env, done.shape[1], iall.device)
        return _seq_bwd_plain(wh, bhn, iall, done, h0, hseq, dhseq.float(), idx)

    @torch.no_grad()
    def _launch(self, wh, bhn, iall, done, h0, hseq, dhseq, start_env, n_env, split=None):
        hg = self.dims.hidden
        tensors = [x.contiguous() for x in (iall, done, h0, hseq, dhseq)] \
            + self._weights(wh, bhn)
        grads, d_iall, dh0 = self._run("fused_gru_seq_bwd", (), (), tensors, iall, done,
                                       start_env, n_env, split)
        FusedGruSeqBwd.all_launches += 1
        n_w = hg * 3 * hg
        return grads[:n_w].view(hg, 3 * hg), grads[n_w:].view(1, hg), d_iall, dh0


class FusedGruLossBwd(_SeqBwdLaunch):
    """``bwd(wh, bhn, whead, bhead, iall, done, h0, hseq, action, logp, value,
    adv, target, stats, start_env, n_env) -> (d_iall, dwh, dbhn, dwhead,
    dbhead, dh0, mets)``; see :func:`build_fused_gru_loss_bwd`."""

    loss = True

    def __init__(self, dims: GruDims, clip_eps: float, vf_coef: float, ent_coef: float):
        super().__init__(dims)
        if dims.msg_bits:
            raise ValueError("the loss-fused GRU backward has no message head (as "
                             "ippo_rnn.py:879-880: 8-entry batches only)")
        self.clip_eps, self.vf_coef, self.ent_coef = clip_eps, vf_coef, ent_coef

    @property
    def n_heads(self) -> int:
        return self.dims.n_actions + 1

    def _check(self, wh, bhn, whead, bhead, iall, done, h0, hseq, action, logp, value, adv,
               target, stats, start_env, n_env):
        dev = _check_seq(self.dims, wh, bhn, iall, done, h0, start_env, n_env)
        _check_band_seq("hseq", hseq, iall, self.dims.hidden, dev)
        a1 = self.n_heads
        if tuple(whead.shape) != (self.dims.hidden, a1) or tuple(bhead.shape) != (a1,):
            raise ValueError(f"whead and bhead must be ({self.dims.hidden}, {a1}) and ({a1},)")
        want = (iall.shape[0], done.shape[1], iall.shape[2])
        for name, x, dtype in (("action", action, torch.int32), ("logp", logp, torch.float32),
                               ("value", value, torch.float32), ("adv", adv, torch.float32),
                               ("target", target, torch.float32)):
            if tuple(x.shape) != want or x.dtype != dtype or x.device != dev:
                raise ValueError(f"{name} must be {dtype} {want} on {dev}")
        if tuple(stats.shape) != (2,) or stats.device != dev:
            raise ValueError(f"stats must be (2,) on {dev}")
        return dev

    def __call__(self, wh, bhn, whead, bhead, iall, done, h0, hseq, action, logp, value, adv,
                 target, stats, start_env: int, n_env: int):
        args = (wh, bhn, whead, bhead, iall, done, h0, hseq, action, logp, value, adv, target,
                stats, start_env, n_env)
        dev = self._check(*args)
        if dev.type == "cuda":
            return self._launch(*args)
        if dev.type == "cpu":
            return self.plain(*args)
        raise ValueError(f"no loss-fused GRU backward kernel for device {dev}")

    @torch.no_grad()
    def plain(self, wh, bhn, whead, bhead, iall, done, h0, hseq, action, logp, value, adv,
              target, stats, start_env: int, n_env: int):
        """The plain PyTorch version (``pallas_gru.py:886-951``, then the
        sweep of :class:`FusedGruSeqBwd`): :meth:`heads_loss_bwd` of the
        band, and ``dheads whead^T`` as each step's cotangent."""
        self._check(wh, bhn, whead, bhead, iall, done, h0, hseq, action, logp, value, adv,
                    target, stats, start_env, n_env)
        idx = band_index(start_env, n_env, done.shape[1], iall.device)
        whead = whead.detach().float()
        streams = [x[:, idx] for x in (action, logp, value, adv, target)]
        dheads, terms = self.heads_loss_bwd(hseq, whead, bhead, streams, stats)
        mets = torch.stack([x.sum() for x in terms])
        hf, a1 = hseq.float(), self.n_heads
        dwhead = hf.reshape(-1, hf.shape[-1]).t() @ dheads.reshape(-1, a1)
        dbhead = dheads.reshape(-1, a1).sum(0)
        dwh, dbhn, d_iall, dh0 = _seq_bwd_plain(wh, bhn, iall, done, h0, hseq,
                                                dheads @ whead.t(), idx)
        return d_iall, dwh, dbhn, dwhead, dbhead, dh0, mets

    @torch.no_grad()
    def heads_loss_bwd(self, hseq, whead, bhead, streams, stats):
        """The f32 heads of ``hseq`` against ``whead`` (Hg, A+1) and ``bhead``,
        and the clipped-PPO loss's backward with the band's ``stats`` =
        [adv_mean, 1 / (adv_std + 1e-8)]; ``streams`` = (action, logp, value,
        adv, target) of the band.  Returns (dheads (T, n_env, N, A+1), the
        per-sample terms of the four metric sums)."""
        eps, a = self.clip_eps, self.dims.n_actions
        inv_n = 1.0 / hseq[..., 0].numel()
        stats = stats.detach().float()
        heads = hseq.float() @ whead + bhead.detach().float()
        logits, val = heads[..., :a], heads[..., a]
        act, old_logp, old_value, advb, tgt = streams
        mx = logits.max(-1, keepdim=True).values
        sm = torch.exp(logits - mx)
        zs = sm.sum(-1, keepdim=True)
        lsm = logits - mx - torch.log(zs)
        pr = sm / zs
        onehot = torch.nn.functional.one_hot(act.long(), a).float()
        lp = lsm.gather(-1, act.long()[..., None])[..., 0]
        ratio = torch.exp(lp - old_logp)
        advn = (advb - stats[0]) * stats[1]
        pg1, pg2 = ratio * advn, torch.clamp(ratio, 1.0 - eps, 1.0 + eps) * advn
        inside = ((ratio > 1.0 - eps) & (ratio < 1.0 + eps)).float()
        dobj = torch.where(pg1 <= pg2, advn, advn * inside)
        ent = -(pr * lsm).sum(-1)
        dlogits = (-inv_n * dobj * ratio)[..., None] * (onehot - pr) \
            + (self.ent_coef * inv_n) * pr * (lsm + ent[..., None])
        vdiff = val - old_value
        e1 = val - tgt
        e2 = old_value + torch.clamp(vdiff, -eps, eps) - tgt
        inside_v = ((vdiff > -eps) & (vdiff < eps)).float()
        dvalue = (self.vf_coef * inv_n) * torch.where(e1 * e1 >= e2 * e2, e1, e2 * inside_v)
        dheads = torch.cat([dlogits, dvalue[..., None]], -1)
        terms = (torch.minimum(pg1, pg2), 0.5 * torch.maximum(e1 * e1, e2 * e2), ent,
                 (ratio - 1.0) - (lp - old_logp))
        return dheads, terms

    @torch.no_grad()
    def _launch(self, wh, bhn, whead, bhead, iall, done, h0, hseq, action, logp, value, adv,
                target, stats, start_env, n_env, split=None):
        hg, a1 = self.dims.hidden, self.n_heads
        head = torch.cat([whead.detach().float(), bhead.detach().float()[None]], 0)
        tensors = [x.contiguous() for x in (stats.float(), iall, done, h0, hseq, action, logp,
                                            value, adv, target)] \
            + self._weights(wh, bhn) + [head.contiguous()]
        scalars = (self.clip_eps, self.vf_coef, self.ent_coef, 1.0 / hseq[..., 0].numel())
        grads, d_iall, dh0 = self._run("fused_gru_loss_bwd", (a1 - 1,), scalars, tensors, iall,
                                       done, start_env, n_env, split)
        n_w = hg * 3 * hg
        o_head = n_w + hg + hg * a1
        return (d_iall, grads[:n_w].view(hg, 3 * hg), grads[n_w:n_w + hg].view(1, hg),
                grads[n_w + hg:o_head].view(hg, a1), grads[o_head:o_head + a1], dh0,
                grads[o_head + a1:])


def build_fused_gru_seq_fwd(dims: GruDims) -> FusedGruSeqFwd:
    """Returns ``fwd(wh, bhn, iall, done, h0, start_env, n_env) -> hseq``:
    ``wh`` (Hg, 3Hg) and ``bhn`` (1, Hg) float32 (``wh`` rounded to bf16),
    the band's fused input gates ``iall`` (T, n_env, N, 3Hg) bf16, the whole
    trajectory's ``done`` (T, B) bool and carry ``h0`` (B, N, Hg) bf16 read
    through the band; ``hseq`` (T, n_env, N, Hg) bf16 is each step's hidden
    BEFORE the reset where ``done`` (``pallas_gru.py:78-170``)."""
    return FusedGruSeqFwd(dims)


def build_fused_gru_seq_bwd(dims: GruDims) -> FusedGruSeqBwd:
    """Returns ``bwd(wh, bhn, iall, done, h0, hseq, dhseq, start_env, n_env) ->
    (dwh (Hg, 3Hg), dbhn (1, Hg), d_iall (T, n_env, N, 3Hg) bf16 = [dr | dz |
    dn], dh0 (n_env, N, Hg))``, float32 but ``d_iall``, from the bf16
    cotangent ``dhseq`` of K11's ``hseq`` (``pallas_gru.py:172-327``).  Two
    launches give the same bits."""
    return FusedGruSeqBwd(dims)


def build_fused_gru_loss_bwd(dims: GruDims, clip_eps: float, vf_coef: float,
                             ent_coef: float) -> FusedGruLossBwd:
    """Returns ``bwd(wh, bhn, whead, bhead, iall, done, h0, hseq, action, logp,
    value, adv, target, stats, start_env, n_env) -> (d_iall, dwh, dbhn,
    dwhead, dbhead, dh0, mets)``: K12's sweep with the heads ``[W_policy |
    W_value]`` (``whead`` (Hg, A+1), ``bhead`` (A+1,) float32, not rounded),
    the clipped-PPO loss of ``rnn_ppo_loss_native`` and its backward inside
    (``pallas_gru.py:823-1070``).  ``action`` (T, B, N) int32 and ``logp``,
    ``value``, ``adv``, ``target`` (T, B, N) float32 are the whole
    trajectory's, read through the band; ``stats`` = [adv_mean, 1 / (adv_std
    + 1e-8)] of the band.  ``mets`` = the sums [min(pg1, pg2), 0.5 max(e1^2,
    e2^2), entropy, (ratio - 1) - log ratio] over the band's T n_env N
    samples.  Two launches give the same bits."""
    return FusedGruLossBwd(dims, clip_eps, vf_coef, ent_coef)


class GruSeqScan(torch.autograd.Function):
    """``hseq = GruSeqScan.apply(wh, bhn, iall, done, h0, start_env, n_env,
    fwd, bwd)``: the forward is ``fwd`` (K11) and the backward ``bwd`` (K12),
    as ``_gru_scan`` of the JAX package on its sequence kernels.  ``wh``
    enters in bf16 (``ippo_rnn.py:636-643``), so its gradient is rounded to
    bf16; ``iall`` gets the bf16 ``d_iall``, ``h0`` (when it asks) ``dh0`` in
    its band rows and zeros elsewhere; ``done`` gets none."""

    @staticmethod
    def forward(ctx, wh, bhn, iall, done, h0, start_env, n_env, fwd, bwd):
        hseq = fwd(wh, bhn, iall, done, h0, start_env, n_env)
        ctx.save_for_backward(wh, bhn, iall, done, h0, hseq)
        ctx.band, ctx.bwd = (start_env, n_env), bwd
        return hseq

    @staticmethod
    def backward(ctx, dhseq):
        wh, bhn, iall, done, h0, hseq = ctx.saved_tensors
        dwh, dbhn, d_iall, dh0 = ctx.bwd(wh, bhn, iall, done, h0, hseq,
                                         dhseq.to(torch.bfloat16).contiguous(), *ctx.band)
        dh0_full = None
        if ctx.needs_input_grad[4]:
            idx = band_index(*ctx.band, h0.shape[0], h0.device)
            dh0_full = torch.zeros(h0.shape, dtype=torch.float32, device=h0.device)
            dh0_full[idx] = dh0
            dh0_full = dh0_full.to(h0.dtype)
        return (rnd_bf16(dwh).to(wh.dtype), dbhn.to(bhn.dtype), d_iall.to(iall.dtype), None,
                dh0_full) + (None,) * 4
