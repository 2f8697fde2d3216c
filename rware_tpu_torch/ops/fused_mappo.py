"""MAPPO's fused kernels: the critic-values kernel (K6), the combined actor +
central-critic gradient kernel (K5) and the whole-MAPPO-phase kernel (K7) —
the counterparts of ``build_fused_critic_values``, ``build_fused_mappo_grads``
and ``build_fused_mappo_update_phase`` of ``rware_tpu/ops/pallas_update.py``.

* :class:`FusedCriticValues` (K6): the central critic's forward over the
  whole stored trajectory, obs ``(T, B, N, L)`` bf16 -> values ``(T, B, N)``.
* :class:`FusedMappoGrads` (K5): the gradient of
  :func:`rware_tpu_torch.models.ppo.mappo_loss_native` over one minibatch
  window (rows ``(start + t) % T_full`` of the trajectory, read in place) for
  both networks, plus the window's four metric sums; ``with_actor=False`` is
  the critic-only variant (:func:`~rware_tpu_torch.models.ppo.critic_value_loss`).
* :class:`FusedMappoUpdatePhase` (K7): all E x M passes of K5, each followed
  by a global-norm clip and an Adam step per part, with both parts'
  parameters and moments kept on the device between passes.

The joint observation of env ``b`` at time ``t`` is the contiguous row
``obs[t, b]`` (N, L) flattened, which is flax's agent-major feature order
``n * L + l`` already.  So the critic's dense_0 stays in flax's order and,
unlike the TPU kernels (``_critic_perm``), nothing here permutes it.

Parameters, gradients and moments are flat float32 vectors: the actor's in
the layout of :class:`~rware_tpu_torch.models.networks.BlockDims`, the
critic's in that of :class:`~rware_tpu_torch.models.networks.CriticDims`;
where both travel together they are a dict ``{"actor", "critic"}``.  Each
wrapper launches its CUDA kernels (``csrc/fused_critic_values.cu``,
``csrc/fused_mappo_grads.cu``, ``csrc/fused_mappo_update.cu``, all on
``csrc/ppo_sample.cuh``) for tensors on a CUDA device and runs its plain
PyTorch version (``.plain``) only for tensors on the CPU; it counts its
launches in ``.launches``.  Kernel and plain version agree to float32
summation order (the bf16 roundings sit at the same places), not bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from rware_tpu_torch.models.networks import (
    BlockDims,
    CriticDims,
    critic_train_forward,
    joint_obs,
)
from rware_tpu_torch.models.ppo import (
    LossCoefs,
    clip_adam,
    critic_value_loss,
    loss_grads,
    mappo_loss_native,
)
from rware_tpu_torch.ops.fused_update import (
    N_SMS,
    FusedPPOGrads,
    PpoPlan,
    _ptr,
    check_widths,
    device_sms,
    phase_time_block,
    pick_tile,
    ppo_plan,
    window_advstats,
    window_rows,
)

Parts = Dict[str, torch.Tensor]  # {"actor": flat, "critic": flat}


def _check_critic_dims(cdims: CriticDims) -> None:
    check_widths(cdims.h1, cdims.h2)


def _check_flat(x: torch.Tensor, n: int, what: str, device=None) -> None:
    if x.shape != (n,) or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{what} must be ({n},) float32, contiguous")
    if device is not None and x.device != device:
        raise ValueError(f"{what} must be on {device}")


def _critic_tile(cdims: CriticDims) -> Tuple[int, bool]:
    """(samples per tile, dense_0 resident in shared memory) of the critic's
    kernels.  dense_0 (N*L, CH1) in bf16 stays in a block's shared memory up
    to 8 agents at L = 71, hidden (128, 128); else it is streamed through it."""
    n = cdims.n_agents
    return pick_tile(cdims.joint_len, cdims.h1, cdims.h2, n, n)


def critic_plan(cdims: CriticDims, n_samples: int, n_sms: int = N_SMS,
                backward: bool = True) -> PpoPlan:
    """:func:`~rware_tpu_torch.ops.fused_update.ppo_plan` of the critic over
    ``n_samples`` samples (t, b): its input is the joint observation, its
    heads are the agents' values."""
    n = cdims.n_agents
    return ppo_plan(cdims.joint_len, cdims.h1, cdims.h2, n, n, n_samples, n_sms, backward)


class FusedCriticValues:
    """``values(cparams, obs (T, B, N, L) bf16) -> (T, B, N) float32``; see
    :func:`build_fused_critic_values`."""

    def __init__(self, cdims: CriticDims):
        _check_critic_dims(cdims)
        self.cdims = cdims
        self.tile, self.w0_smem = _critic_tile(cdims)
        self.launches = 0

    def check(self, cparams: torch.Tensor, obs: torch.Tensor) -> None:
        d = self.cdims
        if obs.ndim != 4 or tuple(obs.shape[2:]) != (d.n_agents, d.obs_len) \
                or obs.dtype != torch.bfloat16 or not obs.is_contiguous():
            raise ValueError(f"obs must be (T, B, {d.n_agents}, {d.obs_len}) bf16, contiguous")
        _check_flat(cparams, d.n_params, "critic params", obs.device)

    def __call__(self, cparams: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        self.check(cparams, obs)
        if obs.device.type == "cuda":
            return self._launch(cparams, obs)
        if obs.device.type == "cpu":
            return self.plain(cparams, obs)
        raise ValueError(f"no fused critic values for device {obs.device}")

    def plain(self, cparams: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version: ``critic_train_forward`` on the joint
        observations."""
        self.check(cparams, obs)
        with torch.no_grad():
            return critic_train_forward(self.cdims.split(cparams), joint_obs(obs))

    def _launch(self, cparams, obs):
        from rware_tpu_torch.ops._build import check, load_library

        lib = load_library()
        dev = obs.device
        d = self.cdims
        t, b = obs.shape[:2]
        with torch.cuda.device(dev):
            plan = critic_plan(d, t * b, device_sms(dev), backward=False)
            values = torch.empty((t, b, d.n_agents), dtype=torch.float32, device=dev)
            code = lib.rw_fused_critic_values(
                d.joint_len, d.h1, d.h2, d.n_agents, t, b, *plan.args()[:4], _ptr(obs),
                _ptr(cparams),
                _ptr(values), torch.cuda.current_stream(dev).cuda_stream)
            check(lib, code, "fused_critic_values")
            self.launches += 1
        return values


def build_fused_critic_values(cdims: CriticDims) -> FusedCriticValues:
    """Returns ``values(cparams, obs) -> (T, B, N)``: the central critic's
    values of every stored step, in the kernels' rounding (f32 bias joined
    before the one bf16 rounding, ``pallas_update.py:1786-1804``)."""
    return FusedCriticValues(cdims)


class FusedMappoGrads:
    """``grads(params, data, start, advstats=None) -> (grads, sums (4,))``;
    see :func:`build_fused_mappo_grads`."""

    def __init__(self, dims: Optional[BlockDims], cdims: CriticDims, t_mb: int, clip_eps: float,
                 vf_coef: float, ent_coef: float, with_actor: bool = True):
        _check_critic_dims(cdims)
        self.with_actor = with_actor
        self.dims = dims if with_actor else None
        self.cdims = cdims
        self.t_mb = t_mb
        self.cfg = LossCoefs(clip_eps, vf_coef, ent_coef)
        # the actor's sizes, shapes and shared-memory choice are K4's
        if dims is not None and dims.msg_bits:
            raise NotImplementedError("the combined MAPPO kernels take no message head (as "
                                      "mappo.py:369-393); message bits take the split path")
        self.actor = FusedPPOGrads(dims, t_mb, clip_eps, vf_coef, ent_coef) if with_actor else None
        if with_actor and dims.obs_len != cdims.obs_len:
            raise ValueError("actor and critic disagree on the observation length")
        self.tile, self.w0_smem = _critic_tile(cdims)
        self.launches = 0

    def check(self, params, data: Sequence[torch.Tensor]) -> None:
        d = self.cdims
        if self.with_actor:
            self.actor.check(params["actor"], data)
            cparams = params["critic"]
        else:
            obs, *rest = data
            want = tuple(obs.shape[:3])
            if obs.ndim != 4 or obs.dtype != torch.bfloat16 or len(rest) != 2:
                raise ValueError("data must be (obs (T, B, N, L) bf16, old_value, target)")
            for x in rest:
                if tuple(x.shape) != want or x.dtype != torch.float32 or x.device != obs.device:
                    raise ValueError(f"old_value and target must be {want} float32")
            if obs.shape[0] < self.t_mb:
                raise ValueError(f"the trajectory holds {obs.shape[0]} < {self.t_mb} time rows")
            if not all(x.is_contiguous() for x in data):
                raise ValueError("data must be contiguous")
            cparams = params
        if tuple(data[0].shape[2:]) != (d.n_agents, d.obs_len):
            raise ValueError(f"obs must be (T, B, {d.n_agents}, {d.obs_len})")
        _check_flat(cparams, d.n_params, "critic params", data[0].device)

    def __call__(self, params, data, start=0, advstats: Optional[torch.Tensor] = None):
        self.check(params, data)
        dev = data[0].device
        if dev.type == "cuda":
            return self._launch(params, data, start, advstats)
        if dev.type == "cpu":
            return self.plain(params, data, start, advstats)
        raise ValueError(f"no fused MAPPO gradient for device {dev}")

    def plain(self, params, data, start=0, advstats: Optional[torch.Tensor] = None):
        """The plain PyTorch version: autograd of ``mappo_loss_native`` (or
        of ``critic_value_loss``) on the window, with the kernel's rounding
        in the tanh backward."""
        self.check(params, data)
        rows = window_rows(start, self.t_mb, data[0].shape[0], data[0].device)
        batch = tuple(x.index_select(0, rows) for x in data)
        n = batch[1].numel()
        if not self.with_actor:
            grads, metrics = loss_grads(
                lambda p: critic_value_loss(self.cfg, self.cdims, p, batch), params)
            zero = torch.zeros((), dtype=torch.float32, device=params.device)
            return grads, torch.stack([zero, metrics["v_loss"] * n, zero, zero])
        if advstats is None:
            advstats = window_advstats(data[4], start, self.t_mb)
        grads, metrics = loss_grads(
            lambda p: mappo_loss_native(self.cfg, self.dims, self.cdims, p, batch, advstats),
            params)
        sums = torch.stack([-metrics["pg_loss"] * n, metrics["v_loss"] * n,
                            metrics["entropy"] * n, metrics["approx_kl"] * n])
        return grads, sums

    def kernel_args(self, data, device) -> Tuple[list, list]:
        """(leading C arguments, workspace tensors of both networks) of one
        window of the trajectory ``data``."""
        t_full, b, n, l_obs = data[0].shape
        d, cfg = self.cdims, self.cfg
        s_c = self.t_mb * b
        if self.with_actor:
            args, ws_a = self.actor.kernel_args(data, device)
        else:
            args = [l_obs, 0, 0, 0, t_full, self.t_mb, b, n, cfg.clip_eps, cfg.vf_coef,
                    cfg.ent_coef, 1.0 / (s_c * n), 0, 0, 0, 0, 0, 0, 0]
            ws_a = [None] * 7
        plan = critic_plan(d, s_c, device_sms(device))
        return args + plan.args() + [d.h1, d.h2], ws_a + plan.workspace(device)

    def _launch(self, params, data, start, advstats):
        from rware_tpu_torch.ops._build import check, load_library

        lib = load_library()
        dev = data[0].device
        with torch.cuda.device(dev):
            f32 = dict(dtype=torch.float32, device=dev)
            if self.with_actor:
                if advstats is None:
                    advstats = window_advstats(data[4], start, self.t_mb)
                stats = advstats.to(**f32).contiguous()
                aparams, cparams = params["actor"], params["critic"]
                agrads = torch.empty(self.dims.n_params, **f32)
                full = data
            else:
                stats, aparams, agrads, cparams = None, None, None, params
                full = (data[0], None, None, data[1], None, data[2])
            start_t = torch.as_tensor(start, device=dev).to(torch.int32).reshape(1)
            args, ws = self.kernel_args(data, dev)
            cgrads = torch.empty(self.cdims.n_params, **f32)
            sums = torch.empty(4, **f32)
            code = lib.rw_fused_mappo_grads(
                *args, int(self.with_actor), _ptr(start_t), _ptr(stats),
                *[_ptr(x) for x in full], _ptr(aparams), _ptr(cparams), *[_ptr(w) for w in ws],
                _ptr(agrads), _ptr(cgrads), _ptr(sums),
                torch.cuda.current_stream(dev).cuda_stream)
            check(lib, code, "fused_mappo_grads")
            self.launches += 1
        if not self.with_actor:
            return cgrads, sums
        return {"actor": agrads, "critic": cgrads}, sums


def build_fused_mappo_grads(dims: Optional[BlockDims], cdims: CriticDims, rollout_len: int,
                            clip_eps: float, vf_coef: float, ent_coef: float,
                            with_actor: bool = True) -> FusedMappoGrads:
    """Returns ``grads(params, data, start=0, advstats=None) -> (grads,
    sums)``: MAPPO's gradients of the ``rollout_len``-row window at ``start``
    of the full trajectory ``data`` = (obs (T, B, N, L) bf16, action (T, B, N)
    int32, old logp, old value (the critic's), advantage, target (T, B, N)
    float32) for ``params`` = {"actor", "critic"} flat vectors (``grads``
    likewise), and the window's sums of [min(pg1, pg2), 0.5 max(e1^2, e2^2)
    (critic), entropy, (ratio - 1) - log ratio].  The actor's local value
    head gets a gradient of exactly zero.  ``advstats`` [mean, 1/std]
    defaults to the window's own (``pallas_update.py:1679-1687``).

    ``with_actor=False`` is the critic-only variant
    (``pallas_update.py:1536-1539``): ``params`` is the critic's flat vector,
    ``data`` = (obs, old value, target), and the return is (critic grads,
    sums) with only the value sum set."""
    return FusedMappoGrads(dims, cdims, rollout_len, clip_eps, vf_coef, ent_coef, with_actor)


class FusedMappoUpdatePhase:
    """``update(params, mu, nu, data, starts, advstats, hyper) -> (params,
    mu, nu, metrics (P, 4))`` on ``{"actor", "critic"}`` dicts; see
    :func:`build_fused_mappo_update_phase`."""

    def __init__(self, dims: BlockDims, cdims: CriticDims, dataset_len: int, epochs: int,
                 minibatches: int, clip_eps: float, vf_coef: float, ent_coef: float,
                 max_grad_norm: float):
        if dims.msg_bits:
            raise NotImplementedError("the whole-MAPPO-phase kernel takes no message head (as "
                                      "mappo.py:369-393)")
        if dataset_len % minibatches:
            raise ValueError(f"minibatches={minibatches} must divide rollout_len={dataset_len}")
        self.t_full = dataset_len
        self.t_mb = dataset_len // minibatches
        self.n_passes = epochs * minibatches
        self.time_block = phase_time_block(self.t_mb)
        self.max_grad_norm = max_grad_norm
        self.grads = FusedMappoGrads(dims, cdims, self.t_mb, clip_eps, vf_coef, ent_coef)
        self.launches = 0

    def _check(self, params, mu, nu, data, starts, advstats, hyper):
        self.grads.check(params, data)
        dev = data[0].device
        if data[0].shape[0] != self.t_full:
            raise ValueError(f"the trajectory must hold {self.t_full} time rows")
        for part, n in (("actor", self.grads.dims.n_params), ("critic", self.grads.cdims.n_params)):
            for x, what in ((mu[part], "mu"), (nu[part], "nu")):
                _check_flat(x, n, f"{part} {what}", dev)
        p = self.n_passes
        for x, shape in ((starts, (p,)), (advstats, (p, 2)), (hyper, (p, 3))):
            if tuple(x.shape) != shape or x.device != dev:
                raise ValueError(f"expected {shape} on {dev}, got {tuple(x.shape)} on {x.device}")

    def __call__(self, params: Parts, mu: Parts, nu: Parts, data, starts, advstats, hyper):
        self._check(params, mu, nu, data, starts, advstats, hyper)
        dev = data[0].device
        if dev.type == "cuda":
            return self._launch(params, mu, nu, data, starts, advstats, hyper)
        if dev.type == "cpu":
            return self.plain(params, mu, nu, data, starts, advstats, hyper)
        raise ValueError(f"no fused MAPPO update phase for device {dev}")

    def plain(self, params: Parts, mu: Parts, nu: Parts, data, starts, advstats, hyper):
        """The plain PyTorch version: P passes of the K5 plain version, each
        followed by the optimizer step of each part."""
        self._check(params, mu, nu, data, starts, advstats, hyper)
        params, mu, nu = dict(params), dict(mu), dict(nu)
        mets = []
        for p in range(self.n_passes):
            g, sums = self.grads.plain(params, data, int(starts[p]), advstats[p])
            for part in ("actor", "critic"):
                params[part], mu[part], nu[part] = clip_adam(
                    params[part], g[part], mu[part], nu[part], hyper[p], self.max_grad_norm)
            mets.append(sums)
        return params, mu, nu, torch.stack(mets)

    def _launch(self, params, mu, nu, data, starts, advstats, hyper):
        from rware_tpu_torch.ops._build import check, load_library

        lib = load_library()
        dev = data[0].device
        with torch.cuda.device(dev):
            args, ws = self.grads.kernel_args(data, dev)
            params, mu, nu = ({k: x[k].clone() for k in ("actor", "critic")}
                              for x in (params, mu, nu))
            starts = starts.to(torch.int32).contiguous()
            advstats = advstats.to(torch.float32).contiguous()
            hyper = hyper.to(torch.float32).contiguous()
            grads = {k: torch.empty_like(v) for k, v in params.items()}
            mets = torch.empty((self.n_passes, 4), dtype=torch.float32, device=dev)
            state = [x[k] for k in ("actor", "critic") for x in (params, mu, nu)]
            code = lib.rw_fused_mappo_update_phase(
                *args, self.max_grad_norm, self.n_passes, _ptr(starts), _ptr(advstats),
                _ptr(hyper), *[_ptr(x) for x in data], *[_ptr(x) for x in state],
                *[_ptr(w) for w in ws], _ptr(grads["actor"]), _ptr(grads["critic"]), _ptr(mets),
                torch.cuda.current_stream(dev).cuda_stream)
            check(lib, code, "fused_mappo_update_phase")
            self.launches += 1
        return params, mu, nu, mets


def build_fused_mappo_update_phase(dims: BlockDims, cdims: CriticDims, dataset_len: int,
                                   epochs: int, minibatches: int, clip_eps: float,
                                   vf_coef: float, ent_coef: float,
                                   max_grad_norm: float) -> FusedMappoUpdatePhase:
    """Returns ``update(params, mu, nu, data, starts, advstats, hyper) ->
    (params, mu, nu, metrics (P, 4))``: MAPPO's whole update phase of P = E x M
    passes over the full trajectory ``data`` (as for
    :func:`build_fused_mappo_grads`); ``params``, ``mu`` and ``nu`` are
    ``{"actor", "critic"}`` dicts of flat vectors.  Pass p takes the window
    ``starts[p]`` with advantage stats ``advstats[p]`` = [mean, 1/std]; then
    each part is clipped by its own global norm and takes an Adam step with
    the shared row ``hyper[p]`` = [lr_t, 1/(1-b1^t), 1/(1-b2^t)]
    (``pallas_update.py:1944-1969``)."""
    return FusedMappoUpdatePhase(dims, cdims, dataset_len, epochs, minibatches, clip_eps,
                                 vf_coef, ent_coef, max_grad_norm)


__all__ = [
    "FusedCriticValues", "FusedMappoGrads", "FusedMappoUpdatePhase", "build_fused_critic_values",
    "build_fused_mappo_grads", "build_fused_mappo_update_phase",
]
