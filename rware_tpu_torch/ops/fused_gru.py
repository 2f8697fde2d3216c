"""The obs-fused GRU sequence kernels: forward (K9) and backward (K10).

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

Each wrapper launches its CUDA kernel (``csrc/fused_gru_fwd.cu``,
``csrc/fused_gru_bwd.cu``) for tensors on a CUDA device and runs its plain
PyTorch version (``.plain``) only for tensors on the CPU; it counts its kernel
launches in ``.launches``.  ``weights`` are the first six blocks of
:class:`~rware_tpu_torch.models.networks.GruDims`: ``We (L, E)``, ``be (1,
E)``, ``Wi (E, 3Hg)``, ``bi (1, 3Hg)``, ``Wh (Hg, 3Hg)``, ``bhn (1, Hg)``,
float32; the kernels round the matrices to bf16.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from rware_tpu_torch.models.networks import (
    GruDims,
    rnd_bf16,
    split_gates,
    gru_replay_step,
    sigmoid_f32,
)

MAX_WIDTH = 128  # the kernels' embed and hidden widths: multiples of 8 up to this
SWEEP_SMS = 132  # blocks of 32 sequences only when they fill the card's SMs


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


def _rows_per_thread(n_seq: int) -> int:
    return 2 if n_seq >= 32 * SWEEP_SMS else 1


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to(torch.bfloat16).contiguous()


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to(torch.float32).contiguous()


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

        _kernel_dims(self.dims)
        lib = load_library()
        dev = obs.device
        t_len, b, n, l_obs = obs.shape
        we, be, wi, bi, wh, bhn = weights
        with torch.cuda.device(dev):
            args = [obs.contiguous(), done.contiguous(), h0.contiguous(), _bf16(we), _f32(be),
                    _bf16(wi), _f32(bi), _bf16(wh), _f32(bhn)]
            hseq = torch.empty((t_len, n_env, n, self.dims.hidden), dtype=torch.bfloat16,
                               device=dev)
            code = lib.rw_fused_gru_fwd(
                l_obs, self.dims.embed, self.dims.hidden, t_len, b, n, start_env, n_env,
                _rows_per_thread(n_env * n), *[a.data_ptr() for a in args], hseq.data_ptr(),
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

    def _workspace(self, dev, n_samples: int, n_chunks: int, sweep_blocks: int):
        key = (dev, n_samples, n_chunks, sweep_blocks)
        if key not in self._scratch:
            self._scratch.clear()  # one shape at a time: the buffers are large
            e, hg = self.dims.embed, self.dims.hidden

            def buf(width):
                return torch.empty((n_samples, width), dtype=torch.bfloat16, device=dev)

            self._scratch[key] = {
                "hp": buf(hg), "e": buf(e), "dg3": buf(3 * hg), "dgi": buf(3 * hg), "dpre": buf(e),
                "part_bhn": torch.empty((sweep_blocks, hg), dtype=torch.float32, device=dev),
                "partial": torch.empty((n_chunks, self.n_grads - hg), dtype=torch.float32,
                                       device=dev),
            }
        return self._scratch[key]

    @torch.no_grad()
    def _launch(self, weights, obs, done, h0, hseq, dhseq, start_env, n_env):
        from rware_tpu_torch.ops._build import check, load_library

        _kernel_dims(self.dims)
        lib = load_library()
        dev = obs.device
        t_len, b, n, l_obs = obs.shape
        we, be, wi, bi, wh, bhn = weights
        n_seq = n_env * n
        n_samples = t_len * n_seq
        rpt = _rows_per_thread(n_seq)
        sweep_blocks = -(-n_seq // (16 * rpt))
        # up to 128 weight-gradient partials, each over a multiple of 32 samples
        n_chunks = min(128, -(-n_samples // 1024))
        chunk = 32 * -(-n_samples // (32 * n_chunks))
        with torch.cuda.device(dev):
            ws = self._workspace(dev, n_samples, n_chunks, sweep_blocks)
            wib, whb = _bf16(wi), _bf16(wh)
            args = [obs.contiguous(), done.contiguous(), h0.contiguous(), hseq.contiguous(),
                    dhseq.contiguous(), _bf16(we), _f32(be), wib, _f32(bi), whb, _f32(bhn),
                    wib.t().contiguous(), whb.t().contiguous(),
                    ws["hp"], ws["e"], ws["dg3"], ws["dgi"], ws["dpre"], ws["part_bhn"],
                    ws["partial"]]
            grads = torch.empty(self.n_grads, dtype=torch.float32, device=dev)
            dh0 = torch.empty((n_env, n, self.dims.hidden), dtype=torch.float32, device=dev)
            code = lib.rw_fused_gru_bwd(
                l_obs, self.dims.embed, self.dims.hidden, t_len, b, n, start_env, n_env, rpt,
                chunk, n_chunks, *[a.data_ptr() for a in args], grads.data_ptr(), dh0.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
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
