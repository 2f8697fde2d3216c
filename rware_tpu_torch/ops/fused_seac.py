"""SEAC-PPO's fused gradient kernel (K8): the counterpart of
``rware_tpu/ops/pallas_update.py::build_fused_seac_ppo_grads``.

:class:`FusedSeacGrads` computes, for every agent i at once, the gradient of
:func:`rware_tpu_torch.models.ppo.seac_loss_native` with respect to agent
i's own parameters over one minibatch window: agent i's network on the
samples of EVERY agent j, the ratio of agent i's policy to agent j's
behaviour policy clipped, pair weight 1 on the diagonal and ``seac_lambda``
off it, the entropy bonus and the KL on the diagonal only.  The window is
rows ``(start + t) % T_full``, ``t < T_mb``, of the ``(T_full, B, N, ...)``
trajectory and of the ``(N_i, T_full, B, N_j)`` cross arrays, read in place.

Parameters and gradients are ``(N, P)`` float32 stacks, row i agent i's flat
vector in the layout of :class:`~rware_tpu_torch.models.networks.BlockDims`.
The wrapper launches the CUDA kernels (``csrc/fused_seac_grads.cu`` on
``csrc/ppo_sample.cuh``) for tensors on a CUDA device and runs its plain
PyTorch version (``.plain``) only for tensors on the CPU; it counts its
launches in ``.launches``.  Kernel and plain version agree to float32
summation order (the bf16 roundings sit at the same places), not bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from rware_tpu_torch.models.networks import BlockDims
from rware_tpu_torch.models.ppo import loss_grads, seac_loss_native
from rware_tpu_torch.ops.fused_update import FusedPPOGrads, _ptr, window_advstats, window_rows


class FusedSeacGrads:
    """``grads(params (N, P), data, start, advstats=None) -> (grads (N, P),
    sums (4,))``; see :func:`build_fused_seac_grads`."""

    def __init__(self, dims: BlockDims, n_agents: int, t_mb: int, clip_eps: float,
                 vf_coef: float, ent_coef: float, seac_lambda: float):
        # agent i's pass over the window is K4's: its checks on the sizes, its
        # tile, launch shape and per-sample workspace
        if dims.msg_bits:
            raise NotImplementedError("the SEAC-PPO gradient kernel takes no message head (as "
                                      "JAX's K8): SEAC-PPO with message bits runs the flat "
                                      "learner")
        self.ppo = FusedPPOGrads(dims, t_mb, clip_eps, vf_coef, ent_coef)
        self.dims, self.n_agents, self.t_mb, self.tile = dims, n_agents, t_mb, self.ppo.tile
        self.cfg, self.seac_lambda = self.ppo.cfg, seac_lambda
        self.launches = 0

    def check(self, params: torch.Tensor, data: Sequence[torch.Tensor]) -> None:
        obs, action, logp, *cross = data
        n = self.n_agents
        if obs.ndim != 4 or obs.shape[2:] != (n, self.dims.obs_len) \
                or obs.dtype != torch.bfloat16:
            raise ValueError(f"obs must be (T, B, {n}, {self.dims.obs_len}) bf16")
        t_full, b = obs.shape[:2]
        if tuple(action.shape) != (t_full, b, n) or action.dtype != torch.int32:
            raise ValueError(f"action must be {(t_full, b, n)} int32")
        if tuple(logp.shape) != (t_full, b, n) or logp.dtype != torch.float32:
            raise ValueError(f"behaviour logp must be {(t_full, b, n)} float32")
        for x in cross:
            if tuple(x.shape) != (n, t_full, b, n) or x.dtype != torch.float32:
                raise ValueError(f"old value, advantage and target must be "
                                 f"{(n, t_full, b, n)} float32")
        if t_full < self.t_mb:
            raise ValueError(f"the trajectory holds {t_full} < {self.t_mb} time rows")
        if params.shape != (n, self.dims.n_params) or params.dtype != torch.float32:
            raise ValueError(f"params must be ({n}, {self.dims.n_params}) float32")
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
        raise ValueError(f"no fused SEAC gradient for device {params.device}")

    def plain(self, params, data, start, advstats: Optional[torch.Tensor] = None):
        """The plain PyTorch version: autograd of ``seac_loss_native`` on the
        window, with the kernel's rounding in the tanh backward."""
        self.check(params, data)
        if advstats is None:
            advstats = window_advstats(data[4], start, self.t_mb, time_dim=1)
        rows = window_rows(start, self.t_mb, data[0].shape[0], params.device)
        batch = tuple(x.index_select(0, rows) for x in data[:3]) \
            + tuple(x.index_select(1, rows) for x in data[3:])
        grads, metrics = loss_grads(
            lambda p: seac_loss_native(self.cfg, self.seac_lambda, self.dims, p, batch, advstats),
            params)
        n = batch[1].numel()
        sums = torch.stack([-metrics["pg_loss"] * n, metrics["v_loss"] * n,
                            metrics["entropy"] * n, metrics["approx_kl"] * n])
        return grads, sums

    def kernel_args(self, data, device) -> Tuple[list, list]:
        """(leading C arguments, workspace tensors) of one window: K4's, the
        per-sample scratch shared by the agents in turn, and every agent's
        per-block metric partials."""
        args, ws = self.ppo.kernel_args(data, device)
        grid = args[13]  # [..., tile, grid, smem, ...]
        ws[6] = torch.empty((self.n_agents * grid, 4), dtype=torch.float32, device=device)
        return args + [self.seac_lambda], ws

    def _launch(self, params, data, start, advstats):
        from rware_tpu_torch.ops._build import check, load_library

        lib = load_library()
        dev = params.device
        with torch.cuda.device(dev):
            if advstats is None:
                advstats = window_advstats(data[4], start, self.t_mb, time_dim=1)
            stats = advstats.to(device=dev, dtype=torch.float32).contiguous()
            start_t = torch.as_tensor(start, device=dev).to(torch.int32).reshape(1)
            args, ws = self.kernel_args(data, dev)
            grads = torch.empty_like(params)
            sums = torch.empty(4, dtype=torch.float32, device=dev)
            code = lib.rw_fused_seac_grads(
                *args, _ptr(start_t), _ptr(stats), *[_ptr(x) for x in data], _ptr(params),
                *[_ptr(w) for w in ws], _ptr(grads), _ptr(sums),
                torch.cuda.current_stream(dev).cuda_stream,
            )
            check(lib, code, "fused_seac_grads")
            self.launches += 1
        return grads, sums


def build_fused_seac_grads(dims: BlockDims, n_agents: int, rollout_len: int, clip_eps: float,
                           vf_coef: float, ent_coef: float, seac_lambda: float) -> FusedSeacGrads:
    """Returns ``grads(params, data, start, advstats=None) -> (grads, sums)``:
    every agent's SEAC-PPO gradient of the ``rollout_len``-row window at
    ``start`` of ``data`` = (obs (T, B, N, L) bf16, action (T, B, N) int32,
    behaviour logp (T, B, N) float32, old value, advantage, target (N_i, T, B,
    N_j) float32) for ``params`` (N, P) (``grads`` likewise), and the window's
    sums, over all pairs, of [w * min(pg1, pg2), w * 0.5 max(e1^2, e2^2),
    diagonal entropy, diagonal (ratio - 1) - log ratio] (``pallas_update.py:
    706-714``; divided by T_mb * B * N they are the metrics).  ``advstats``
    [mean, 1/std] defaults to the window's own over all its pairs."""
    return FusedSeacGrads(dims, n_agents, rollout_len, clip_eps, vf_coef, ent_coef, seac_lambda)


__all__ = ["FusedSeacGrads", "build_fused_seac_grads"]
