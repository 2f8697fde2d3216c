"""The fused PPO gradient kernel (K4) and the whole-update-phase kernel (K3).

* :class:`FusedPPOGrads` replaces
  ``rware_tpu/ops/pallas_update.py::build_fused_ppo_grads`` in zero-copy mode:
  the gradient of the clipped-PPO loss of
  :func:`rware_tpu_torch.models.ppo.ppo_loss_native` over one
  minibatch window — rows ``(start + t) % T_full``, ``t < T_mb``, of the
  ``(T_full, B, N, ...)`` trajectory, read in place — plus the window's four
  metric sums.  With message bits (``dims.msg_bits`` M > 0) it takes the
  message head: a 7th dataset entry holds the bits, and the loss is that of
  the joint move + Bernoulli-bits policy (``pallas_update.py:185-244``).
* :class:`FusedPPOUpdatePhase` replaces ``build_fused_ppo_update_phase``:
  all E x M passes, each the K4 gradient then a global-norm clip and an Adam
  step, with parameters and moments kept on the device between passes.  It
  takes no message head, as JAX's does not (``ippo_pallas.py:545-556``).

Parameters, gradients and moments are flat float32 vectors in the layout of
:class:`~rware_tpu_torch.models.networks.BlockDims`.  Each wrapper launches
its CUDA kernels (``csrc/fused_ppo_grads.cu``, ``csrc/fused_ppo_update.cu``)
for tensors on a CUDA device and runs its plain PyTorch version
(``.plain``) only for tensors on the CPU; it counts its launches in
``.launches``.  Kernel and plain version agree to float32 summation order
(the bf16 roundings sit at the same places), not bit for bit.

:func:`ppo_plan` is the launch plan of the PPO kernels that K3-K8 share
(``csrc/ppo_sample.cuh`` and the weight-gradient pass of
``csrc/gru_wgrad.cuh``): tile, grid and shared memory of each kernel, the
weight-gradient chunks and the scratch, for one network over one window.
Every wrapper of those kernels takes its launch numbers from it.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from rware_tpu_torch.models.networks import BlockDims
from rware_tpu_torch.models.ppo import (
    METRIC_KEYS,
    LossCoefs,
    clip_adam,
    loss_grads,
    ppo_loss_native,
)

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
SMEM_PER_SM = 233472
HEAD_ROWS = 8  # PPO_HC of csrc/ppo_core.cuh: A + 1 <= 8
HEAD_ROWS_MAX = 16  # PPO_HC_MAX: with K4's message head, A + 1 + M <= 16
MAX_WIDTH = 128  # PPO_HMAX: the widest hidden layer of the tensor-core tiles
N_SMS = 132  # the H100's SMs, for plans made without a card

# The per-sample kernel's tiles (csrc/ppo_core.cuh, csrc/ppo_sample.cuh):
# samples a tile, dense_0's k chunk, bf16 columns added to each shared-memory
# row, blocks an SM (its __launch_bounds__)
TILE, _KC, _PAD, _BLOCKS_PER_SM = 64, 64, 8, 2
# The weight-gradient pass (csrc/gru_wgrad.cuh): threads, samples a step,
# buffers, output tile
_WG_THREADS, _WG_SK, _WG_NS, _WG_TI, _WG_TJ = 512, 64, 3, 128, 128


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def phase_time_block(t_mb: int) -> int:
    """The time block of ``pallas_update.py:888-898``: epoch rotations are
    drawn in these units so the port's windows are the JAX windows."""
    for tb in (4, 2):
        if t_mb % tb == 0:
            return tb
    return 1


def check_widths(h1: int, h2: int) -> None:
    """Raise ``ValueError`` for hidden widths the PPO kernels do not take."""
    if any(h % 4 or h < 4 or h > MAX_WIDTH for h in (h1, h2)):
        raise ValueError(f"the PPO kernels take hidden widths that are multiples of 4 up to "
                         f"{MAX_WIDTH}, not ({h1}, {h2})")


def sample_smem(k0: int, h1: int, h2: int, heads: int, hc: int, tile: int = TILE,
                w0_smem: bool = True) -> int:
    """Dynamic shared memory of one block of the per-sample kernel
    (``ppo_smem`` in ``csrc/ppo_core.cuh``, which the library checks this
    against) for an input of ``k0`` features, ``heads <= hc`` head columns and
    ``hc`` head rows kept per sample; ``w0_smem`` keeps dense_0's weights
    there, else one 64-row chunk of them at a time."""
    if tile != TILE or heads > hc:
        raise ValueError(f"the per-sample kernel takes tiles of {TILE} samples and at most "
                         f"{hc} head columns")
    h1p, h2p, hcp, k0p = _up(h1, 16), _up(h2, 16), _up(hc, 4), _up(k0, 16)
    # b0, b1, Wc, Wc^T, bc, the head tile, the sums of dWc and (by sample slot) dbc
    f32 = h1p + h2p + h2 * hcp + hcp * h2p + hcp + TILE * hcp + h2 * hcp + TILE * hcp
    bf16 = h1p * (h2p + _PAD) + (k0p if w0_smem else _KC) * (h1p + _PAD) \
        + TILE * (max(h1p, h2p, _KC) + _PAD)
    return 4 * f32 + 8 * TILE + 2 * bf16


def wgrad_smem() -> int:
    """Dynamic shared memory of the weight-gradient kernel
    (``gru_wgrad_smem`` in ``csrc/gru_wgrad.cuh``)."""
    return 2 * _WG_NS * _WG_SK * ((_WG_TI + _PAD) + (_WG_TJ + _PAD)) + 4 * _WG_THREADS


def head_rows(dims: BlockDims) -> int:
    """Head rows the per-sample kernel keeps per sample for the actor
    ``dims``: 8, or 16 where a message head makes A + 1 + M larger."""
    return HEAD_ROWS if dims.heads <= HEAD_ROWS else HEAD_ROWS_MAX


def pick_tile(k0: int, h1: int, h2: int, heads: int, hc: int) -> Tuple[int, bool]:
    """(samples per tile, dense_0 resident in shared memory) of the
    per-sample kernel: dense_0's weights stay in shared memory where they
    fit, else they are streamed through it in 64-row chunks."""
    check_widths(h1, h2)
    for w0_smem in (True, False):
        if sample_smem(k0, h1, h2, heads, hc, TILE, w0_smem) <= SMEM_LIMIT:
            return TILE, w0_smem
    raise ValueError("hidden widths too wide for the PPO kernel's shared memory")


def device_sms(device) -> int:
    """The SMs of the CUDA ``device``, or :data:`N_SMS` for any other."""
    device = torch.device(device)
    if device.type != "cuda":
        return N_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


@dataclasses.dataclass(frozen=True)
class PpoPlan:
    """The launch plan of the PPO kernels for one network over one window of
    ``n_samples`` samples: the per-sample kernel's tile, grid and shared
    memory, whether dense_0 is resident, the weight-gradient chunks and the
    scratch (``csrc/fused_ppo_grads.cu`` refuses numbers that are not its
    own)."""

    n_samples: int
    tile: int
    grid: int  # persistent blocks of the per-sample kernel: block b takes tiles b, b + grid, ...
    w0_smem: bool
    smem: Dict[str, int]  # "sample", and with a backward "wgrad": dynamic shared memory, bytes
    chunk: int  # samples a weight-gradient partial (0 without a backward)
    n_chunks: int
    scratch: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]  # in the C argument order

    def args(self) -> list:
        """[tile, grid, smem, w0_smem, chunk, n_chunks, wgrad_smem] of the C
        entry points."""
        return [self.tile, self.grid, self.smem["sample"], int(self.w0_smem), self.chunk,
                self.n_chunks, self.smem.get("wgrad", 0)]

    def block_tiles(self) -> List[List[range]]:
        """The samples of each tile, block by block."""
        n_tiles = -(-self.n_samples // self.tile)
        return [[range(t * self.tile, min((t + 1) * self.tile, self.n_samples))
                 for t in range(b, n_tiles, self.grid)] for b in range(self.grid)]

    def chunks(self) -> List[range]:
        """The samples of each weight-gradient partial."""
        return [range(c * self.chunk, min((c + 1) * self.chunk, self.n_samples))
                for c in range(self.n_chunks)]

    def workspace(self, device) -> List[torch.Tensor]:
        """The scratch tensors, in the C argument order."""
        return [torch.empty(shape, dtype=dtype, device=device)
                for shape, dtype in self.scratch.values()]


def ppo_plan(k0: int, h1: int, h2: int, heads: int, hc: int, n_samples: int,
             n_sms: int = N_SMS, backward: bool = True) -> PpoPlan:
    """The plan of the PPO kernels for a network of input ``k0``, hidden
    ``(h1, h2)``, ``heads`` head columns (``hc`` kept per sample) over
    ``n_samples`` samples on a card of ``n_sms`` SMs: dense_0 resident where
    it fits, up to two blocks an SM, the weight gradients in at most 128
    chunks of a multiple of 64 samples.  ``backward=False`` is the forward
    alone (K6).  Raises ``ValueError`` for widths the kernels do not take."""
    tile, w0_smem = pick_tile(k0, h1, h2, heads, hc)
    smem = {"sample": sample_smem(k0, h1, h2, heads, hc, tile, w0_smem)}
    per_sm = max(1, min(_BLOCKS_PER_SM, SMEM_PER_SM // (smem["sample"] + 1024)))
    grid = min(-(-n_samples // tile), n_sms * per_sm)
    if not backward:
        return PpoPlan(n_samples, tile, grid, w0_smem, smem, 0, 0, {})
    smem["wgrad"] = wgrad_smem()
    chunk = _WG_SK * -(-n_samples // (_WG_SK * min(128, -(-n_samples // 1024))))
    n_chunks = -(-n_samples // chunk)
    bf, f32 = torch.bfloat16, torch.float32
    n_w = (k0 + 1) * h1 + (h1 + 1) * h2  # [dW0 | db0 | dW1 | db1]
    scratch = {
        "h1": ((n_samples, _up(h1, 8)), bf), "h2": ((n_samples, _up(h2, 8)), bf),
        "dz1": ((n_samples, _up(h1, 8)), bf), "dz2": ((n_samples, _up(h2, 8)), bf),
        "part_head": ((grid, (h2 + 1) * heads), f32), "partial": ((n_chunks, n_w), f32),
        "part_mets": ((grid, 4), f32),
    }
    return PpoPlan(n_samples, tile, grid, w0_smem, smem, chunk, n_chunks, scratch)


def window_rows(start, t_mb: int, t_full: int, device) -> torch.Tensor:
    """Trajectory rows ``(start + t) % T_full`` of a window."""
    return (torch.arange(t_mb, device=device) + start) % t_full


def window_advstats(adv: torch.Tensor, start, t_mb: int, time_dim: int = 0) -> torch.Tensor:
    """[mean, 1/(std + 1e-8)] of the advantages of a window, time on
    ``time_dim`` (population std, as ``pallas_update.py:458-469``; SEAC's
    ``(N_i, T, B, N_j)`` cross advantages over all pairs, ``:828-829``)."""
    win = adv.index_select(time_dim, window_rows(start, t_mb, adv.shape[time_dim], adv.device))
    return torch.stack([win.mean(), 1.0 / (win.std(correction=0) + 1e-8)]).to(torch.float32)


def metric_means(sums: torch.Tensor, n: int) -> dict:
    """The PPO metrics of (..., 4) window sums over ``n`` samples."""
    return {"pg_loss": -sums[..., 0] / n, "v_loss": sums[..., 1] / n,
            "entropy": sums[..., 2] / n, "approx_kl": sums[..., 3] / n}


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


class FusedPPOGrads:
    """``grads(params, data, start, advstats=None) -> (grads (n_params,),
    sums (4,))``; see :func:`build_fused_ppo_grads`."""

    def __init__(self, dims: BlockDims, t_mb: int, clip_eps: float, vf_coef: float,
                 ent_coef: float):
        check_widths(dims.h1, dims.h2)
        if dims.n_actions + 1 > HEAD_ROWS or dims.heads > HEAD_ROWS_MAX:
            raise ValueError(f"the PPO kernels take at most {HEAD_ROWS - 1} actions and "
                             f"{HEAD_ROWS_MAX} head columns")
        self.dims = dims
        self.t_mb = t_mb
        self.cfg = LossCoefs(clip_eps, vf_coef, ent_coef)
        self.hc = head_rows(dims)
        # dense_0's weights stay in shared memory up to sensor range 4 at
        # hidden (128, 128); from sensor range 5 they are streamed through it
        self.tile, self.w0_smem = pick_tile(dims.obs_len, dims.h1, dims.h2, dims.heads, self.hc)
        self.launches = 0

    def check(self, params: torch.Tensor, data: Sequence[torch.Tensor]) -> None:
        m = self.dims.msg_bits
        if len(data) != 6 + bool(m):
            raise ValueError(f"data holds {6 + bool(m)} tensors: obs, action, logp, value, adv, "
                             f"target{', bits' if m else ''}")
        obs, action, *rest = data[:6]
        t_full, b, n, l_obs = obs.shape
        want = (t_full, b, n)
        if m and (tuple(data[6].shape) != want + (m,) or data[6].dtype != torch.int32):
            raise ValueError(f"bits must be {want + (m,)} int32")
        if l_obs != self.dims.obs_len or obs.dtype != torch.bfloat16:
            raise ValueError(f"obs must be (T, B, N, {self.dims.obs_len}) bf16")
        if tuple(action.shape) != want or action.dtype != torch.int32:
            raise ValueError(f"action must be {want} int32")
        for x in rest:
            if tuple(x.shape) != want or x.dtype != torch.float32:
                raise ValueError(f"logp, value, adv and target must be {want} float32")
        if t_full < self.t_mb:
            raise ValueError(f"the trajectory holds {t_full} < {self.t_mb} time rows")
        if params.shape != (self.dims.n_params,) or params.dtype != torch.float32:
            raise ValueError(f"params must be ({self.dims.n_params},) float32")
        if any(x.device != params.device for x in data):
            raise ValueError("params and data must be on one device")
        if not all(x.is_contiguous() for x in (params, *data)):
            raise ValueError("params and data must be contiguous")

    def __call__(self, params, data, start, advstats: Optional[torch.Tensor] = None):
        self.check(params, data)
        if params.device.type == "cuda":
            return self._launch(params, data, start, advstats)
        if params.device.type == "cpu":
            return self.plain(params, data, start, advstats)
        raise ValueError(f"no fused PPO gradient for device {params.device}")

    def plain(self, params, data, start, advstats: Optional[torch.Tensor] = None):
        """The plain PyTorch version: autograd of ``ppo_loss_native`` on the
        window, with the kernel's rounding in the tanh backward."""
        self.check(params, data)
        if advstats is None:
            advstats = window_advstats(data[4], start, self.t_mb)
        rows = window_rows(start, self.t_mb, data[0].shape[0], params.device)
        batch = tuple(x.index_select(0, rows) for x in data)
        grads, metrics = loss_grads(
            lambda p: ppo_loss_native(self.cfg, self.dims, p, batch, advstats), params)
        n = batch[1].numel()
        sums = torch.stack([-metrics["pg_loss"] * n, metrics["v_loss"] * n,
                            metrics["entropy"] * n, metrics["approx_kl"] * n])
        return grads, sums

    def plan(self, n_samples: int, n_sms: int = N_SMS) -> PpoPlan:
        """:func:`ppo_plan` of this network over ``n_samples`` samples."""
        d = self.dims
        return ppo_plan(d.obs_len, d.h1, d.h2, d.heads, self.hc, n_samples, n_sms)

    def kernel_args(self, data, device) -> Tuple[list, list]:
        """(leading C arguments, workspace tensors) of one window."""
        t_full, b, n, _ = data[0].shape
        d = self.dims
        s = self.t_mb * b * n
        plan = self.plan(s, device_sms(device))
        args = [d.obs_len, d.h1, d.h2, d.n_actions, t_full, self.t_mb, b, n,
                self.cfg.clip_eps, self.cfg.vf_coef, self.cfg.ent_coef, 1.0 / s, *plan.args()]
        return args, plan.workspace(device)

    def _launch(self, params, data, start, advstats):
        from rware_tpu_torch.ops._build import check, load_library

        lib = load_library()
        dev = params.device
        with torch.cuda.device(dev):
            if advstats is None:
                advstats = window_advstats(data[4], start, self.t_mb)
            stats = advstats.to(device=dev, dtype=torch.float32).contiguous()
            start_t = torch.as_tensor(start, device=dev).to(torch.int32).reshape(1)
            args, ws = self.kernel_args(data, dev)
            grads = torch.empty(self.dims.n_params, dtype=torch.float32, device=dev)
            sums = torch.empty(4, dtype=torch.float32, device=dev)
            bits = data[6] if self.dims.msg_bits else None
            code = lib.rw_fused_ppo_grads(
                *args, self.dims.msg_bits, self.hc, _ptr(start_t), _ptr(stats),
                *[_ptr(x) for x in data[:6]], _ptr(bits), _ptr(params),
                *[_ptr(w) for w in ws], _ptr(grads), _ptr(sums),
                torch.cuda.current_stream(dev).cuda_stream,
            )
            check(lib, code, "fused_ppo_grads")
            self.launches += 1
        return grads, sums


def build_fused_ppo_grads(dims: BlockDims, rollout_len: int, clip_eps: float, vf_coef: float,
                          ent_coef: float) -> FusedPPOGrads:
    """Returns ``grads(params, data, start, advstats=None) -> (grads,
    sums)``: the clipped-PPO gradient of the ``rollout_len``-row window at
    ``start`` of the full trajectory ``data`` = (obs (T, B, N, L) bf16,
    action (T, B, N) int32, old logp, old value, advantage, target (T, B, N)
    float32, and with ``dims.msg_bits`` M > 0 bits (T, B, N, M) int32), and
    the window's sums of [min(pg1, pg2), 0.5 max(e1^2, e2^2), entropy, (ratio
    - 1) - log ratio], the log-probability and entropy those of the joint
    move + bits policy.  ``advstats`` [mean, 1/std] defaults to the window's
    own (``pallas_update.py:458-469``)."""
    return FusedPPOGrads(dims, rollout_len, clip_eps, vf_coef, ent_coef)


class FusedPPOUpdatePhase:
    """``update(params, mu, nu, data, starts, advstats, hyper) -> (params,
    mu, nu, metrics (P, 4))``; see :func:`build_fused_ppo_update_phase`."""

    def __init__(self, dims: BlockDims, dataset_len: int, epochs: int, minibatches: int,
                 clip_eps: float, vf_coef: float, ent_coef: float, max_grad_norm: float):
        if dims.msg_bits:
            raise NotImplementedError("the whole-update-phase kernel takes no message head "
                                      "(as ippo_pallas.py:545-556); use the per-pass path")
        if dataset_len % minibatches:
            raise ValueError(f"minibatches={minibatches} must divide rollout_len={dataset_len}")
        self.t_full = dataset_len
        self.t_mb = dataset_len // minibatches
        self.n_passes = epochs * minibatches
        self.time_block = phase_time_block(self.t_mb)
        self.max_grad_norm = max_grad_norm
        self.grads = FusedPPOGrads(dims, self.t_mb, clip_eps, vf_coef, ent_coef)
        self.launches = 0

    def _check(self, params, mu, nu, data, starts, advstats, hyper):
        self.grads.check(params, data)
        if data[0].shape[0] != self.t_full:
            raise ValueError(f"the trajectory must hold {self.t_full} time rows")
        p = self.n_passes
        for x, shape in ((mu, params.shape), (nu, params.shape), (starts, (p,)),
                         (advstats, (p, 2)), (hyper, (p, 3))):
            if tuple(x.shape) != tuple(shape) or x.device != params.device:
                raise ValueError(f"expected {tuple(shape)} on {params.device}, got "
                                 f"{tuple(x.shape)} on {x.device}")

    def __call__(self, params, mu, nu, data, starts, advstats, hyper):
        self._check(params, mu, nu, data, starts, advstats, hyper)
        if params.device.type == "cuda":
            return self._launch(params, mu, nu, data, starts, advstats, hyper)
        if params.device.type == "cpu":
            return self.plain(params, mu, nu, data, starts, advstats, hyper)
        raise ValueError(f"no fused PPO update phase for device {params.device}")

    def plain(self, params, mu, nu, data, starts, advstats, hyper):
        """The plain PyTorch version: P passes of the K4 plain version, each
        followed by the optimizer step."""
        self._check(params, mu, nu, data, starts, advstats, hyper)
        mets = []
        for p in range(self.n_passes):
            g, sums = self.grads.plain(params, data, int(starts[p]), advstats[p])
            params, mu, nu = clip_adam(params, g, mu, nu, hyper[p], self.max_grad_norm)
            mets.append(sums)
        return params, mu, nu, torch.stack(mets)

    def timed(self, params, mu, nu, data, starts, advstats, hyper):
        """One launch on the card that waits for its kernels and returns
        ``(params, mu, nu, metrics, ms)``: ``ms`` the milliseconds a pass of
        the per-sample kernel, the weight-gradient products, their reduction
        with the metric sums, and the optimizer step, by CUDA events between
        them (means over the passes)."""
        self._check(params, mu, nu, data, starts, advstats, hyper)
        if params.device.type != "cuda":
            raise ValueError("the time split is taken on the card")
        split = (ctypes.c_float * 4)()
        out = self._launch(params, mu, nu, data, starts, advstats, hyper, split)
        keys = ("sample", "wgrad", "reduce", "adam")
        return out + ({k: v / self.n_passes for k, v in zip(keys, split)},)

    def _launch(self, params, mu, nu, data, starts, advstats, hyper, split=None):
        from rware_tpu_torch.ops._build import check, load_library

        lib = load_library()
        dev = params.device
        with torch.cuda.device(dev):
            args, ws = self.grads.kernel_args(data, dev)
            params, mu, nu = (x.to(torch.float32).clone().contiguous() for x in (params, mu, nu))
            starts = starts.to(torch.int32).contiguous()
            advstats = advstats.to(torch.float32).contiguous()
            hyper = hyper.to(torch.float32).contiguous()
            grads = torch.empty_like(params)
            mets = torch.empty((self.n_passes, 4), dtype=torch.float32, device=dev)
            code = lib.rw_fused_ppo_update_phase(
                *args, self.max_grad_norm, self.n_passes, _ptr(starts), _ptr(advstats),
                _ptr(hyper), *[_ptr(x) for x in data], _ptr(params), _ptr(mu),
                _ptr(nu), *[_ptr(w) for w in ws], _ptr(grads), _ptr(mets), split,
                torch.cuda.current_stream(dev).cuda_stream,
            )
            check(lib, code, "fused_ppo_update_phase")
            self.launches += 1
        return params, mu, nu, mets


def build_fused_ppo_update_phase(dims: BlockDims, dataset_len: int, epochs: int,
                                 minibatches: int, clip_eps: float, vf_coef: float,
                                 ent_coef: float, max_grad_norm: float) -> FusedPPOUpdatePhase:
    """Returns ``update(params, mu, nu, data, starts, advstats, hyper) ->
    (params, mu, nu, metrics (P, 4))``: the whole update phase of P = E x M
    passes over the full trajectory ``data`` (as for
    :func:`build_fused_ppo_grads`), pass p on the window ``starts[p]`` with
    advantage stats ``advstats[p]`` = [mean, 1/std] and optimizer row
    ``hyper[p]`` = [lr_t, 1/(1-b1^t), 1/(1-b2^t)]; ``metrics[p]`` holds the
    pass's four metric sums (``pallas_update.py:929-935``)."""
    return FusedPPOUpdatePhase(dims, dataset_len, epochs, minibatches, clip_eps, vf_coef,
                               ent_coef, max_grad_norm)


__all__ = [
    "FusedPPOGrads", "FusedPPOUpdatePhase", "METRIC_KEYS", "PpoPlan", "build_fused_ppo_grads",
    "build_fused_ppo_update_phase", "metric_means", "phase_time_block", "ppo_plan",
    "window_advstats",
]
