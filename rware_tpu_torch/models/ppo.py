"""The clipped-PPO losses (IPPO's, MAPPO's, the critic-only value loss,
SEAC-PPO's) and the clip + Adam step on flat parameter vectors: what the
learners of :mod:`rware_tpu_torch.models.ippo`,
:mod:`rware_tpu_torch.models.ippo_fused`, :mod:`rware_tpu_torch.models.mappo`
and :mod:`rware_tpu_torch.models.seac` and the plain versions of the PPO
kernels (:mod:`rware_tpu_torch.ops.fused_update`,
:mod:`rware_tpu_torch.ops.fused_mappo`, :mod:`rware_tpu_torch.ops.fused_seac`)
share.

The optimizer is optax's ``chain(clip_by_global_norm(max_grad_norm),
adam(lr, eps=1e-5))`` written as the fused update kernel writes it
(``rware_tpu/ops/pallas_update.py:1014-1033``): ``g * scale`` after the
global-norm clip, then Adam with the bias corrections ``1 / (1 - b^t)``
multiplied in.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from rware_tpu_torch.models.networks import (
    BlockDims,
    CriticDims,
    bernoulli_entropy,
    bernoulli_logp,
    critic_train_forward,
    joint_obs,
    train_forward,
)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-5
METRIC_KEYS = ("pg_loss", "v_loss", "entropy", "approx_kl")


class LossCoefs(NamedTuple):
    """The loss's coefficients; an ``IPPOConfig`` serves as well."""

    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01


@dataclasses.dataclass
class AdamState:
    """Adam moments in the flat parameter layout; ``count`` is the optax
    count (steps taken), which the lr schedule reads too."""

    count: int
    mu: torch.Tensor
    nu: torch.Tensor


def _mean(x: torch.Tensor, count: Optional[torch.Tensor]) -> torch.Tensor:
    """``x``'s mean, or with ``count`` its sum over ``count``."""
    return x.mean() if count is None else x.sum() / count


def clipped_ppo_terms(cfg, logits, value, action, old_logp, old_value, adv, target,
                      advstats: Optional[torch.Tensor] = None, bits=None,
                      count: Optional[torch.Tensor] = None):
    """The clipped-PPO objective (surrogate, clipped value loss, entropy
    bonus) from policy logits and values of any source; returns
    ``(total, metrics)`` with the metrics as means.  ``cfg`` holds
    ``clip_eps``, ``vf_coef`` and ``ent_coef``.

    ``advstats`` [mean, 1/std] normalises the advantages as the fused
    kernels do; None takes the mean and population std of ``adv`` itself.
    ``count``, the number of advantage elements of the whole minibatch of
    which ``adv`` is this rank's part, makes every term and metric this
    part's sum over ``count``: summed over the ranks they are the whole
    minibatch's means (``advstats`` then the whole minibatch's too).

    ``bits`` (..., M), the message bits taken, switches to the joint move +
    Bernoulli policy: ``logits`` is then ``(logits, msg_logits)``, and the
    ratio and the entropy are the joint ones (``ippo_pallas.py:142-197``)."""
    if advstats is None:
        advn = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    else:
        advn = (adv - advstats[0]) * advstats[1]
    if bits is not None:
        logits, msg_logits = logits
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, action.long()[..., None])[..., 0]
    if bits is not None:
        logp = logp + bernoulli_logp(msg_logits, bits).sum(-1)
    ratio = torch.exp(logp - old_logp)
    pg1 = ratio * advn
    pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * advn
    pg_loss = -_mean(torch.minimum(pg1, pg2), count)
    v_clipped = old_value + torch.clamp(value - old_value, -cfg.clip_eps, cfg.clip_eps)
    v_loss = 0.5 * _mean(torch.maximum((value - target) ** 2, (v_clipped - target) ** 2), count)
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1)
    if bits is not None:
        entropy = entropy + bernoulli_entropy(msg_logits)
    entropy = _mean(entropy, count)
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
    with torch.no_grad():
        approx_kl = _mean((ratio - 1) - (logp - old_logp), count)
    metrics = {"pg_loss": pg_loss.detach(), "v_loss": v_loss.detach(),
               "entropy": entropy.detach(), "approx_kl": approx_kl}
    return total, metrics


def ppo_loss_native(cfg, dims: BlockDims, params: torch.Tensor, batch,
                    advstats: Optional[torch.Tensor] = None):
    """Clipped-PPO loss on a ``(T, B, N, ...)`` minibatch ``(obs, action,
    old_logp, old_value, adv, target)``, with a 7th entry, the bits (T, B, N,
    M), where ``dims`` has message bits; ``advstats`` as in
    :func:`clipped_ppo_terms`.  Returns (total, metrics)."""
    obs, action, old_logp, old_value, adv, target = batch[:6]
    heads, value = train_forward(dims.split(params), obs, dims.msg_bits)
    return clipped_ppo_terms(cfg, heads, value, action, old_logp, old_value, adv, target,
                             advstats, batch[6] if dims.msg_bits else None)


def mappo_loss_native(cfg, dims: BlockDims, cdims: CriticDims, params, batch,
                      advstats: Optional[torch.Tensor] = None, xla_grad: bool = False):
    """Clipped MAPPO loss (``mappo.py:100-117``) on a ``(T, B, N, ...)``
    minibatch ``(obs, action, old_logp, old_value, adv, target)``, with a
    7th entry, the bits (T, B, N, M), where ``dims`` has message bits: the
    policy terms from the actor ``params["actor"]`` (the joint move +
    Bernoulli policy with bits), the value term from the central critic
    ``params["critic"]`` on the joint observation.  ``old_value``, ``adv``
    and ``target`` are the critic's; the actor's local value head takes no
    part.  ``xla_grad`` takes the tanh's gradient as JAX's autodiff gives it
    (:func:`~rware_tpu_torch.models.networks.train_forward`), not as the
    kernels do.  Returns (total, metrics)."""
    obs, action, old_logp, old_value, adv, target = batch[:6]
    heads, _ = train_forward(dims.split(params["actor"]), obs, dims.msg_bits, xla_grad)
    value = critic_train_forward(cdims.split(params["critic"]), joint_obs(obs), xla_grad)
    return clipped_ppo_terms(cfg, heads, value, action, old_logp, old_value, adv, target,
                             advstats, batch[6] if dims.msg_bits else None)


def critic_value_loss(cfg, cdims: CriticDims, cparams: torch.Tensor, batch):
    """The critic-only clipped value loss (``mappo.py:870-879``) on
    ``(obs (T, B, N, L), old_value, target (T, B, N))``: returns
    (``vf_coef * v_loss``, {"v_loss"})."""
    obs, old_value, target = batch
    value = critic_train_forward(cdims.split(cparams), joint_obs(obs))
    v_clipped = old_value + torch.clamp(value - old_value, -cfg.clip_eps, cfg.clip_eps)
    v_loss = 0.5 * torch.maximum((value - target) ** 2, (v_clipped - target) ** 2).mean()
    return cfg.vf_coef * v_loss, {"v_loss": v_loss.detach()}


def cross_logp(logits, action, bits=None):
    """(log pi_i(a_j | o_j), entropy of pi_i on o_j) of agent i's heads on
    agent j's samples (``cross_logp``, ``seac.py:415-441``; the A2C loss's
    ``cross_joint_logp``, ``seac.py:142-168``): ``logits`` (..., A) and
    ``action`` broadcast to the heads' batch shape.  ``bits`` (..., M), the
    message bits taken (broadcast like ``action``), switches to the joint
    move + Bernoulli policy: ``logits`` is then ``(logits, msg_logits)`` and
    both outputs are the joint ones."""
    if bits is not None:
        logits, msg_logits = logits
    lsm = torch.log_softmax(logits, dim=-1)
    idx = action.long().expand(lsm.shape[:-1])[..., None]
    logp = lsm.gather(-1, idx)[..., 0]
    ent_map = -(torch.exp(lsm) * lsm).sum(-1)
    if bits is not None:
        logp = logp + bernoulli_logp(msg_logits, bits).sum(-1)
        ent_map = ent_map + bernoulli_entropy(msg_logits)
    return logp, ent_map


def seac_terms(cfg, seac_lambda: float, logits, value, action, behav_logp, old_value, adv,
               target, i_axis: int, advstats: Optional[torch.Tensor] = None, bits=None,
               count: Optional[torch.Tensor] = None):
    """The SEAC-PPO objective (``seac.py:443-480``) on agent i's heads over
    agent j's samples: ``logits`` (..., A) and ``value`` with the agent axes
    at ``i_axis`` (agent i, whose network ran) and last (agent j, whose
    sample it is); ``action`` and ``behav_logp`` broadcast over ``i_axis``.
    The ratio is ``pi_i / pi_j,behaviour``; the policy and value terms are
    summed over j with pair weights ``eye + seac_lambda (1 - eye)`` and
    averaged over the rest; entropy and ``approx_kl`` come from the diagonal.
    ``advstats`` [mean, 1/std] as in :func:`clipped_ppo_terms` (None: the
    mean and population std of all of ``adv``).  ``bits`` (..., M), the
    message bits taken (broadcast over ``i_axis`` like ``action``), switches
    to the joint move + Bernoulli policy: ``logits`` is then ``(logits,
    msg_logits)`` and the log-prob and the entropy are the joint ones
    (:func:`cross_logp`).  ``count``, the number of advantage elements of the
    whole minibatch of which these are this rank's part, makes every term
    and metric this part's sum over ``count / N`` (the pairs are summed over
    j), as :func:`clipped_ppo_terms`.  Returns (total, metrics)."""
    if advstats is None:
        advn = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    else:
        advn = (adv - advstats[0]) * advstats[1]
    logp, ent_map = cross_logp(logits, action, bits)
    ratio = torch.exp(logp - behav_logp)
    pg1 = ratio * advn
    pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * advn
    surr = -torch.minimum(pg1, pg2)
    n = logp.shape[i_axis]
    rows = None if count is None else count / n
    eye = torch.eye(n, dtype=torch.float32, device=logp.device)
    shape = [1] * surr.ndim
    shape[i_axis] = shape[-1] = n
    weight = (eye + seac_lambda * (1.0 - eye)).reshape(shape)
    pg_loss = _mean((surr * weight).sum(-1), rows)
    v_clipped = old_value + torch.clamp(value - old_value, -cfg.clip_eps, cfg.clip_eps)
    v_err = torch.maximum((value - target) ** 2, (v_clipped - target) ** 2)
    v_loss = 0.5 * _mean((v_err * weight).sum(-1), rows)
    entropy = _mean(torch.diagonal(ent_map, dim1=i_axis, dim2=-1), rows)
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
    with torch.no_grad():
        own = torch.diagonal(ratio, dim1=i_axis, dim2=-1)
        approx_kl = _mean((own - 1) - torch.log(own), rows)
    metrics = {"pg_loss": pg_loss.detach(), "v_loss": v_loss.detach(),
               "entropy": entropy.detach(), "approx_kl": approx_kl}
    return total, metrics


def seac_loss_native(cfg, seac_lambda: float, dims: BlockDims, params: torch.Tensor, batch,
                     advstats: Optional[torch.Tensor] = None):
    """SEAC-PPO loss in the kernels' rounding (``pallas_update.py:611-704``;
    each agent's network is :func:`train_forward`) on a window ``(obs (T, B,
    N, L), action, behaviour logp (T, B, N), old_value, adv, target (N_i, T,
    B, N_j))`` for ``params`` (N, P), row i agent i's flat vector; advantages
    normalised by ``advstats`` or by the whole window's cross advantages.
    Returns (total, metrics)."""
    obs, action, behav_logp, old_value, adv, target = batch
    heads = [train_forward(dims.split(params[i]), obs) for i in range(params.shape[0])]
    logits = torch.stack([h[0] for h in heads])  # (N_i, T, B, N_j, A)
    value = torch.stack([h[1] for h in heads])
    return seac_terms(cfg, seac_lambda, logits, value, action[None], behav_logp[None], old_value,
                      adv, target, 0, advstats)


def loss_grads(loss_fn: Callable, params):
    """(grads, metrics) of ``loss_fn(params) -> (total, metrics)``;
    ``params`` is a flat tensor, or a dict of them (grads likewise)."""
    with torch.enable_grad():
        if isinstance(params, dict):
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            total, metrics = loss_fn(p)
            grads = dict(zip(p, torch.autograd.grad(total, list(p.values()))))
        else:
            p = params.detach().requires_grad_(True)
            total, metrics = loss_fn(p)
            (grads,) = torch.autograd.grad(total, p)
    return grads, metrics


def clip_adam(params, grads, mu, nu, hyper: torch.Tensor, max_grad_norm: float):
    """One global-norm clip + Adam step on flat tensors with the hyper row
    ``[lr_t, bc1, bc2]``; returns new (params, mu, nu)."""
    gn = torch.sqrt((grads * grads).sum())
    scale = torch.where(gn >= max_grad_norm, max_grad_norm / torch.clamp(gn, min=1e-30),
                        torch.ones_like(gn))
    g = grads * scale
    mu = ADAM_B1 * mu + (1.0 - ADAM_B1) * g
    nu = ADAM_B2 * nu + (1.0 - ADAM_B2) * g * g
    lr, bc1, bc2 = hyper[0], hyper[1], hyper[2]
    params = params - lr * (mu * bc1) / (torch.sqrt(nu * bc2) + ADAM_EPS)
    return params, mu, nu
