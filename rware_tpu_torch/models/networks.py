"""Policy/value network (the counterpart of ``rware_tpu/models/networks.py``).

``ActorCritic`` follows the numerics recipe of the fused collector
(``rware_tpu/ops/pallas_rollout.py::_policy_forward``): bf16 inputs and
weights, f32 accumulation, the f32 bias added, the sum rounded to bf16 and
tanh taken on that bf16 value; the f32 heads read the bf16 hidden.

Every product is accumulated in one fixed order — input feature 0 first,
one rounded multiply and one rounded add per term, no fused multiply-add —
which is the order the fused collector kernel (``csrc/collect_mlp.cuh``)
uses, so on the card the two agree bit for bit.

The recurrent policy (:class:`RecurrentActorCritic`, embed + GRU cell + f32
heads) is at the end of this file, in the three roundings the JAX package
gives one cell: the fused collector's (:func:`gru_collect_step`), the
sequence kernels' (:func:`gru_replay_step`, :func:`gru_replay_heads`) and
flax's own (:func:`gru_apply_step`).

With message bits (``msg_bits`` M > 0, the reference's ``MultiDiscrete([5,
2, ..., 2])`` action) each net gains a float32 ``message`` head of M
Bernoulli logits beside the policy and value heads, and its forwards return
``(logits, msg_logits)`` where they returned the logits, as flax's modules do
(``rware_tpu/models/networks.py:24-49, 93-108``).

The learners train on :func:`train_forward`: the same recipe
(``rware_tpu/models/ippo_pallas.py::_native_trunk``) with ``torch.matmul``
products, differentiable, on the six kernel-layout parameter blocks of
:func:`params_to_arrays` packed into one flat float32 vector
(:class:`BlockDims`).  Their bootstrap value reads :func:`apply_forward`,
the recipe of the JAX package's flax ``ActorCritic`` itself.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


def ordered_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T + bias`` in float32, summed over the input features in
    ascending order with separately rounded multiplies and adds.

    ``x`` (M, K) and ``weight`` (J, K) hold float32 values (bf16-exact where
    the recipe calls for bf16).  Leading axes broadcast: ``x`` (N, M, K),
    ``weight`` (N, J, K) and ``bias`` (N, 1, J) run N products in one loop."""
    acc = torch.zeros(x.shape[:-1] + (weight.shape[-2],), dtype=torch.float32, device=x.device)
    w_t = weight.transpose(-1, -2)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k : k + 1] * w_t[..., k : k + 1, :]
    return acc + bias


def bf16_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh of the bf16-rounded ``x``, rounded to bf16 (returned as float32)."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    return torch.tanh(xb).to(torch.bfloat16).to(torch.float32)


class ActorCritic(nn.Module):
    """Shared-parameter MLP actor-critic: obs (..., L) -> (logits (..., A)
    f32, value (...,) f32), or ``((logits, msg_logits (..., M)), value)``
    with ``msg_bits`` M > 0.  Parameters are float32 (as flax keeps them);
    the forward casts the hidden layers' weights to bf16."""

    def __init__(self, obs_dim: int, n_actions: int = 5,
                 hidden: Sequence[int] = (128, 128), msg_bits: int = 0):
        super().__init__()
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        self.hidden = tuple(hidden)
        self.msg_bits = msg_bits
        widths = (obs_dim,) + self.hidden
        self.dense = nn.ModuleList(
            nn.Linear(widths[i], widths[i + 1]) for i in range(len(self.hidden))
        )
        self.policy = nn.Linear(widths[-1], n_actions)
        self.value = nn.Linear(widths[-1], 1)
        if msg_bits:
            self.message = nn.Linear(widths[-1], msg_bits)

    def heads(self, obs: torch.Tensor):
        """(logits (..., A), value (...,), msg_logits (..., M) or None)."""
        lead = obs.shape[:-1]
        x = obs.reshape(-1, obs.shape[-1]).to(torch.bfloat16).to(torch.float32)
        for layer in self.dense:
            w = layer.weight.to(torch.bfloat16).to(torch.float32)
            x = bf16_tanh(ordered_linear(x, w, layer.bias.float()))
        logits = ordered_linear(x, self.policy.weight.float(), self.policy.bias.float())
        value = ordered_linear(x, self.value.weight.float(), self.value.bias.float())
        msg = None
        if self.msg_bits:
            msg = ordered_linear(x, self.message.weight.float(), self.message.bias.float())
            msg = msg.reshape(lead + (self.msg_bits,))
        return logits.reshape(lead + (self.n_actions,)), value.reshape(lead), msg

    def forward(self, obs: torch.Tensor):
        logits, value, msg = self.heads(obs)
        return (logits if msg is None else (logits, msg)), value


def stacked_heads(policies: Sequence[ActorCritic], obs: torch.Tensor):
    """``policies[i].heads(obs[i])`` for every i, stacked on a leading axis:
    ``obs`` (N, ..., L) -> (logits (N, ..., A), value (N, ...), msg_logits
    (N, ..., M) or None).  The same casts and roundings, every sum in
    :func:`ordered_linear`'s order, so each value equals the per-network
    call's bit for bit; the N networks share one loop over the features."""
    n, lead, p0 = len(policies), obs.shape[1:-1], policies[0]
    x = obs.reshape(n, -1, obs.shape[-1]).to(torch.bfloat16).to(torch.float32)

    def layer(get, bf16=False):
        w = torch.stack([get(p).weight for p in policies]).float()
        w = w.to(torch.bfloat16).to(torch.float32) if bf16 else w
        return w, torch.stack([get(p).bias for p in policies]).float()[:, None]

    for d in range(len(p0.dense)):
        x = bf16_tanh(ordered_linear(x, *layer(lambda p: p.dense[d], bf16=True)))
    logits = ordered_linear(x, *layer(lambda p: p.policy))
    value = ordered_linear(x, *layer(lambda p: p.value))
    msg = None
    if p0.msg_bits:
        msg = ordered_linear(x, *layer(lambda p: p.message)).reshape((n,) + lead + (p0.msg_bits,))
    return logits.reshape((n,) + lead + (p0.n_actions,)), value.reshape((n,) + lead), msg


def sample_action(
    logits: torch.Tensor, uniforms: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gumbel-argmax sample and its log-prob from (..., A) logits.

    ``uniforms`` (..., A) float32 in [0, 1) are the 23-bit uniforms of
    :func:`rware_tpu_torch.ops.philox.gumbel_uniform`; None takes the plain
    argmax (the kernels' deterministic mode).  Formula of
    ``_sample_gumbel`` (pallas_rollout.py:1494-1529).
    """
    if uniforms is None:
        noisy = logits
    else:
        noisy = logits - torch.log(-torch.log(uniforms + 1e-10) + 1e-10)
    action = noisy.argmax(dim=-1)
    mx = logits.amax(dim=-1, keepdim=True)
    lse = mx + torch.log(torch.exp(logits - mx).sum(dim=-1, keepdim=True))
    logp = (logits.gather(-1, action[..., None]) - lse)[..., 0]
    return action.to(torch.int32), logp


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``log sigmoid(x) = min(x, 0) - log(1 + exp(-|x|))`` (the kernels'
    formula, ``pallas_rollout.py:1532-1534``)."""
    return torch.clamp(x, max=0.0) - torch.log(1.0 + torch.exp(-x.abs()))


def bernoulli_logp(logits: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """log p(bits) (..., M) of independent Bernoullis with ``logits``."""
    bits = bits.to(torch.float32)
    return bits * log_sigmoid(logits) + (1.0 - bits) * log_sigmoid(-logits)


def bernoulli_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Summed entropy (...,) of independent Bernoullis with ``logits`` (...,
    M)."""
    p = torch.sigmoid(logits)
    return -(p * log_sigmoid(logits) + (1.0 - p) * log_sigmoid(-logits)).sum(-1)


def sample_bernoulli(msg_logits: torch.Tensor, uniforms: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Message bits (..., M) int32 and their summed log-prob (...,) from
    (..., M) logits: bit k is ``u < sigmoid(l)`` for the 23-bit uniforms
    ``uniforms`` of :func:`rware_tpu_torch.ops.philox.gumbel_uniform`, or
    ``l > 0`` for None (the kernels' deterministic mode); the formula of
    ``_sample_bernoulli`` (pallas_rollout.py:1537-1562).  The sigmoid is
    :func:`sigmoid_f32`, and the log-probs are summed over the bits in
    order, as the collector kernels do (``sample_bernoulli`` in
    ``csrc/collect_core.cuh``): a bit feeds back into the next observation."""
    bit = msg_logits > 0.0 if uniforms is None else uniforms < sigmoid_f32(msg_logits)
    logp = torch.zeros(msg_logits.shape[:-1], dtype=torch.float32, device=msg_logits.device)
    for k in range(msg_logits.shape[-1]):
        lk = msg_logits[..., k]
        log1pe = torch.log(1.0 + torch.exp(-lk.abs()))
        logp = logp + (torch.clamp(torch.where(bit[..., k], lk, -lk), max=0.0) - log1pe)
    return bit.to(torch.int32), logp


def split_heads(hcat: torch.Tensor, msg_bits: int = 0):
    """(heads, value) of the head block's outputs (..., A + 1 + M): heads is
    the logits, or ``(logits, msg_logits)`` with message bits."""
    a = hcat.shape[-1] - 1 - msg_bits
    logits, value = hcat[..., :a], hcat[..., a]
    return (logits if not msg_bits else (logits, hcat[..., a + 1:])), value


# ---------------------------------------------------------------------------
# Training forward on the kernel-layout parameter blocks.
# ---------------------------------------------------------------------------


class _FlatBlocks:
    """``(rows, cols)`` blocks (``shapes``) packed into one flat vector."""

    @property
    def n_params(self) -> int:
        return sum(r * c for r, c in self.shapes)

    def split(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """The blocks as views of ``flat``."""
        sizes = [r * c for r, c in self.shapes]
        return [p.view(s) for p, s in zip(torch.split(flat, sizes), self.shapes)]


@dataclasses.dataclass(frozen=True)
class BlockDims(_FlatBlocks):
    """Sizes of the six kernel-layout blocks of a two-layer ActorCritic
    (``ippo_pallas.py:340-355``): ``W0 (L, H1)``, ``b0 (1, H1)``,
    ``W1 (H1, H2)``, ``b1 (1, H2)``, ``Wc = [policy | value | message]
    (H2, A+1+M)``, ``bc (1, A+1+M)`` (``pallas_update.py:109``).  Packed in
    that order into one flat vector, each weight block followed by its bias
    row is the stacked ``(fan_in + 1, fan_out)`` matrix the CUDA kernels
    address (``csrc/ppo_core.cuh``)."""

    obs_len: int
    h1: int
    h2: int
    n_actions: int = 5
    msg_bits: int = 0

    @property
    def heads(self) -> int:
        """Columns of the head block: A + 1 + M."""
        return self.n_actions + 1 + self.msg_bits

    @property
    def shapes(self) -> List[Tuple[int, int]]:
        ac = self.heads
        return [(self.obs_len, self.h1), (1, self.h1), (self.h1, self.h2), (1, self.h2),
                (self.h2, ac), (1, ac)]

    @staticmethod
    def of(model: "ActorCritic") -> "BlockDims":
        if len(model.hidden) != 2:
            raise ValueError("the learners take two hidden layers")
        return BlockDims(model.obs_dim, model.hidden[0], model.hidden[1], model.n_actions,
                         model.msg_bits)


def pack_arrays(arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    """One flat float32 vector of the blocks."""
    return torch.cat([a.reshape(-1).to(torch.float32) for a in arrays])


def head_layers(model) -> list:
    """The float32 head layers of a net: policy, value and (if any) message."""
    return [model.policy, model.value] + ([model.message] if model.msg_bits else [])


def params_to_arrays(model: "ActorCritic") -> List[torch.Tensor]:
    """The six kernel-layout blocks of ``model`` (``_params_to_arrays`` of
    ``ippo_pallas.py:340``); ``nn.Linear`` keeps (out, in), the blocks
    (in, out)."""
    d0, d1 = model.dense
    heads = head_layers(model)
    return [
        d0.weight.t(), d0.bias[None, :], d1.weight.t(), d1.bias[None, :],
        torch.cat([h.weight for h in heads], 0).t(),
        torch.cat([h.bias for h in heads], 0)[None, :],
    ]


@torch.no_grad()
def _copy_heads(model, wc: torch.Tensor, bc: torch.Tensor) -> None:
    """Columns ``[policy | value | message]`` of ``wc``, ``bc`` into the heads."""
    col = 0
    for layer in head_layers(model):
        width = layer.weight.shape[0]
        layer.weight.copy_(wc[:, col:col + width].t())
        layer.bias.copy_(bc[0, col:col + width])
        col += width


@torch.no_grad()
def arrays_to_params(arrays: Sequence[torch.Tensor],
                     model: Optional["ActorCritic"] = None, msg_bits: int = 0) -> "ActorCritic":
    """Copy the six blocks into ``model`` (a new one with ``msg_bits`` on the
    blocks' device if None) and return it (``_arrays_to_params`` of
    ``ippo_pallas.py:358``)."""
    w0, b0, w1, b1, wc, bc = arrays
    if model is None:
        model = ActorCritic(w0.shape[0], wc.shape[1] - 1 - msg_bits, (w0.shape[1], w1.shape[1]),
                            msg_bits).to(w0.device)
    d0, d1 = model.dense
    d0.weight.copy_(w0.t())
    d0.bias.copy_(b0[0])
    d1.weight.copy_(w1.t())
    d1.bias.copy_(b1[0])
    _copy_heads(model, wc, bc)
    return model


def init_actor_critic(obs_dim: int, n_actions: int = 5, hidden: Sequence[int] = (128, 128),
                      seed: int = 0, msg_bits: int = 0) -> "ActorCritic":
    """An :class:`ActorCritic` with flax ``Dense``'s default init: kernels
    LeCun-normal (truncated at two deviations, unit variance after the
    truncation), biases zero.  The draws come from numpy's generator, so a
    seed gives the same parameters under every torch version."""
    model = ActorCritic(obs_dim, n_actions, hidden, msg_bits)
    _flax_dense_init(list(model.dense) + head_layers(model), np.random.default_rng(seed))
    return model


@torch.no_grad()
def _flax_dense_init(layers, rng: np.random.Generator) -> None:
    """flax ``Dense``'s default init of ``nn.Linear`` layers, drawn from ``rng``."""
    bound = math.erf(2.0 / math.sqrt(2.0))  # truncation at +-2 in erf units
    for layer in layers:
        std = 1.0 / math.sqrt(layer.weight.shape[1]) / 0.87962566103423978
        u = torch.from_numpy(rng.uniform(-bound, bound, tuple(layer.weight.shape)))
        w = torch.erfinv(u) * (std * math.sqrt(2.0))
        layer.weight.copy_(w.clamp(-2 * std, 2 * std))
        layer.bias.zero_()


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (as float32), with the identity as gradient."""
    return x + (x.to(torch.bfloat16).to(torch.float32) - x).detach()


class _Bf16Tanh(torch.autograd.Function):
    """``h = bf16(tanh(u))`` of a bf16-exact ``u``.  Its gradient follows
    the fused update kernels (``pallas_update.py:1134-1139``) and XLA's bf16
    ``tanh``: ``bf16(bf16(g) * bf16(1 - bf16(h * h)))``."""

    @staticmethod
    def forward(ctx, u):
        h = torch.tanh(u).to(torch.bfloat16).to(torch.float32)
        ctx.save_for_backward(h)
        return h

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors

        def rnd(v):
            return v.to(torch.bfloat16).to(torch.float32)

        return rnd(rnd(g) * rnd(1.0 - rnd(h * h)))


class _XlaBf16Tanh(_Bf16Tanh):
    """``h = bf16(tanh(u))`` whose gradient is the one JAX's autodiff gives a
    bf16 ``tanh``: the transpose of the JVP ``(g + g h)(1 - h)`` of
    ``tanh_p`` (``jax/_src/lax/lax.py``), every op rounded to bf16 on the bf16
    cotangent g, ``j = bf16(g bf16(1 - h))`` then ``bf16(j + bf16(j h))``
    (XLA's CPU program, equal bit for bit on 100,000 draws)."""

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors

        def rnd(v):
            return v.to(torch.bfloat16).to(torch.float32)

        j = rnd(rnd(g) * rnd(1.0 - h))
        return rnd(j + rnd(j * h))


def apply_forward(arrays: Sequence[torch.Tensor], obs: torch.Tensor, msg_bits: int = 0):
    """The JAX package's ``ActorCritic.__call__`` on the six blocks (flax
    ``Dense`` with ``dtype=bfloat16``): each hidden layer's product rounded
    to bf16, the bias rounded to bf16 and added in bf16, tanh rounded to
    bf16; float32 heads on the bf16 hidden.  It differs from
    :func:`train_forward` once the biases are nonzero: there the f32 bias
    joins the f32 sum before the one rounding.  The learners' bootstrap
    value (``model.apply`` at ``ippo_pallas.py:612``) reads it.  Returns
    (heads, value) as :func:`split_heads`.

    JAX differentiates the bf16 casts of the hidden weights and biases, so
    their gradients are the batch's sums rounded to bf16.  Here they stay
    float32 sums: a caller that takes a gradient rounds them
    (:func:`round_grad_blocks` with :data:`DENSE_CAST_BLOCKS`) once they are
    summed over every rank's rows."""
    return split_heads(_apply_heads(arrays, obs), msg_bits)


# the blocks of a BlockDims vector whose gradient JAX's bf16 Dense rounds
DENSE_CAST_BLOCKS = (0, 1, 2, 3)


def round_grad_blocks(dims: _FlatBlocks, grads: torch.Tensor, blocks: Sequence[int]
                      ) -> torch.Tensor:
    """``grads`` (a flat vector in ``dims``'s layout, or an (N, P) stack of
    them) with the blocks ``blocks`` rounded to bf16: the gradient of a
    weight cast to bf16 for its product, as JAX's cast is differentiated,
    rounded once the whole batch's sum is taken."""
    rows = grads if grads.dim() == 2 else grads[None]
    parts = list(torch.split(rows, [r * c for r, c in dims.shapes], dim=1))
    for i in blocks:
        parts[i] = rnd_bf16(parts[i])
    out = torch.cat(parts, 1)
    return out if grads.dim() == 2 else out[0]


def _apply_heads(arrays: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Two flax bf16 ``Dense`` + tanh layers and the float32 head block on
    ``x`` (..., K): the head outputs (..., J).  The hidden weights and biases
    are cast by :func:`bf16_round`, so their gradients stay float32 sums (a
    gradient-taking caller rounds them through ``round_grad_blocks(dims,
    grads, DENSE_CAST_BLOCKS)``)."""
    w0, b0, w1, b1, wc, bc = arrays

    def rnd(v):
        return v.to(torch.bfloat16).to(torch.float32)

    h = rnd(x.reshape(-1, x.shape[-1]))
    for w, b in ((w0, b0), (w1, b1)):
        # bf16(tanh) whose gradient reads the bf16 output, as JAX's bf16
        # tanh does: zero where a unit saturates to +-1
        h = _Bf16Tanh.apply(rnd(rnd(h @ bf16_round(w)) + bf16_round(b)))
    return (h @ wc + bc).reshape(x.shape[:-1] + (wc.shape[1],))


def _train_heads(arrays: Sequence[torch.Tensor], x: torch.Tensor,
                 xla_grad: bool = False) -> torch.Tensor:
    """The ``_native_trunk`` recipe and the float32 head block on ``x``
    (..., K), differentiable: the head outputs (..., J).  The tanh's
    gradient is the fused kernels' (:class:`_Bf16Tanh`), with ``xla_grad``
    JAX's autodiff's (:class:`_XlaBf16Tanh`)."""
    w0, b0, w1, b1, wc, bc = arrays
    tanh = _XlaBf16Tanh if xla_grad else _Bf16Tanh
    h = x.reshape(-1, x.shape[-1]).to(torch.bfloat16).to(torch.float32)
    h = tanh.apply(bf16_round(h @ bf16_round(w0) + b0))
    h = tanh.apply(bf16_round(h @ bf16_round(w1) + b1))
    return (h @ wc + bc).reshape(x.shape[:-1] + (wc.shape[1],))


def train_forward(arrays: Sequence[torch.Tensor], obs: torch.Tensor, msg_bits: int = 0,
                  xla_grad: bool = False):
    """Differentiable ActorCritic forward on the six blocks: obs (..., L)
    -> (logits (..., A), value (...,)), all float32; with ``msg_bits`` the
    logits are ``(logits, msg_logits (..., M))`` (:func:`split_heads`).

    The ``_native_trunk`` recipe: bf16 inputs and hidden weights, f32 sums
    (``torch.matmul`` on bf16-exact float32 values), the f32 bias added and
    the sum rounded to bf16, tanh rounded to bf16, f32 heads."""
    return split_heads(_train_heads(arrays, obs, xla_grad), msg_bits)


# ---------------------------------------------------------------------------
# MAPPO's central critic.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CriticDims(_FlatBlocks):
    """Sizes of the six blocks of a two-layer :class:`CentralCritic`, packed
    in this order into one flat vector: ``C0 (N*L, CH1)``, ``cb0 (1, CH1)``,
    ``C1 (CH1, CH2)``, ``cb1 (1, CH2)``, ``Cv (CH2, N)``, ``cbv (1, N)``.
    ``C0``'s rows are in flax's agent-major order ``n * L + l``: the order
    of ``obs[t, b]`` (N, L) flattened, so no permutation is needed."""

    n_agents: int
    obs_len: int
    h1: int
    h2: int

    @property
    def joint_len(self) -> int:
        return self.n_agents * self.obs_len

    @property
    def shapes(self) -> List[Tuple[int, int]]:
        return [(self.joint_len, self.h1), (1, self.h1), (self.h1, self.h2), (1, self.h2),
                (self.h2, self.n_agents), (1, self.n_agents)]

    @staticmethod
    def of(model: "CentralCritic") -> "CriticDims":
        if len(model.hidden) != 2:
            raise ValueError("the learners take two hidden layers")
        return CriticDims(model.n_agents, model.joint_dim // model.n_agents, *model.hidden)


class CentralCritic(nn.Module):
    """Centralized value function: joint obs (..., N*L) -> (..., N) float32
    values, one per agent (the counterpart of the flax ``CentralCritic``,
    in its rounding: :func:`critic_apply_forward`)."""

    def __init__(self, joint_dim: int, n_agents: int, hidden: Sequence[int] = (128, 128)):
        super().__init__()
        if joint_dim % n_agents:
            raise ValueError(f"joint_dim={joint_dim} is not a multiple of n_agents={n_agents}")
        self.joint_dim = joint_dim
        self.n_agents = n_agents
        self.hidden = tuple(hidden)
        widths = (joint_dim,) + self.hidden
        self.dense = nn.ModuleList(
            nn.Linear(widths[i], widths[i + 1]) for i in range(len(self.hidden))
        )
        self.value = nn.Linear(widths[-1], n_agents)

    def forward(self, joint_obs: torch.Tensor) -> torch.Tensor:
        return critic_apply_forward(critic_to_arrays(self), joint_obs)


def critic_to_arrays(model: "CentralCritic") -> List[torch.Tensor]:
    """The six :class:`CriticDims` blocks of ``model``."""
    d0, d1 = model.dense
    return [d0.weight.t(), d0.bias[None, :], d1.weight.t(), d1.bias[None, :],
            model.value.weight.t(), model.value.bias[None, :]]


@torch.no_grad()
def arrays_to_critic(arrays: Sequence[torch.Tensor],
                     model: Optional["CentralCritic"] = None) -> "CentralCritic":
    """Copy the six blocks into ``model`` (a new one on the blocks' device
    if None) and return it."""
    c0, cb0, c1, cb1, cv, cbv = arrays
    if model is None:
        model = CentralCritic(c0.shape[0], cv.shape[1], (c0.shape[1], c1.shape[1])).to(c0.device)
    layers = list(model.dense) + [model.value]
    for layer, w, b in zip(layers, (c0, c1, cv), (cb0, cb1, cbv)):
        layer.weight.copy_(w.t())
        layer.bias.copy_(b[0])
    return model


def init_central_critic(joint_dim: int, n_agents: int, hidden: Sequence[int] = (128, 128),
                        seed=0) -> "CentralCritic":
    """A :class:`CentralCritic` with flax ``Dense``'s default init, drawn
    from ``numpy.random.default_rng(seed)`` (see :func:`init_actor_critic`)."""
    model = CentralCritic(joint_dim, n_agents, hidden)
    _flax_dense_init(list(model.dense) + [model.value], np.random.default_rng(seed))
    return model


def joint_obs(obs: torch.Tensor) -> torch.Tensor:
    """(..., N, L) per-agent observations -> (..., N*L) joint observation,
    agent-major: a view, since each env's (N, L) rows are contiguous."""
    return obs.reshape(obs.shape[:-2] + (obs.shape[-2] * obs.shape[-1],))


def critic_train_forward(arrays: Sequence[torch.Tensor], joint: torch.Tensor,
                         xla_grad: bool = False) -> torch.Tensor:
    """Differentiable critic forward in the kernels' rounding
    (``pallas_update.py:1350-1366``): joint obs (..., N*L) -> (..., N);
    ``xla_grad`` as in :func:`train_forward`."""
    return _train_heads(arrays, joint, xla_grad)


def critic_apply_forward(arrays: Sequence[torch.Tensor], joint: torch.Tensor) -> torch.Tensor:
    """The flax ``CentralCritic.__call__`` on the six blocks, in flax's
    rounding (see :func:`apply_forward`); MAPPO's bootstrap value
    (``critic.apply`` at ``mappo.py:604-607``) reads it."""
    return _apply_heads(arrays, joint)


# ---------------------------------------------------------------------------
# The recurrent actor-critic: embed + GRU cell + float32 heads.
# ---------------------------------------------------------------------------


def rnd_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, as float32 (no gradient)."""
    return x.to(torch.bfloat16).to(torch.float32)


def ordered_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in float32 for ``x`` (M, K) and ``w`` (K, J), summed over k
    in ascending order with separately rounded multiplies and adds: the
    order of the collector kernels (see :func:`ordered_linear`).  Leading
    axes broadcast: ``x`` (N, M, K) and ``w`` (N, K, J) run N products in one
    loop."""
    acc = torch.zeros(x.shape[:-1] + (w.shape[-1],), dtype=torch.float32, device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k : k + 1] * w[..., k : k + 1, :]
    return acc


def sigmoid_f32(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` in float32, written out so that the CUDA kernels
    evaluate the same formula (``expf``, one rounded add, one rounded
    division)."""
    return 1.0 / (1.0 + torch.exp(-x))


class _Bf16Param(torch.autograd.Function):
    """A float32 weight cast to bf16 for a product, as JAX's
    ``w.astype(bfloat16)`` is differentiated: the gradient arrives in bf16."""

    @staticmethod
    def forward(ctx, w):
        return rnd_bf16(w)

    @staticmethod
    def backward(ctx, g):
        return rnd_bf16(g)


def bf16_param(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to bf16 (as float32); its gradient is rounded to bf16."""
    return _Bf16Param.apply(w)


@dataclasses.dataclass(frozen=True)
class GruDims(_FlatBlocks):
    """Sizes of the eight blocks of a :class:`RecurrentActorCritic`, packed
    in this order into one flat vector: ``We (L, E)``, ``be (1, E)``,
    ``Wi = [ir | iz | in] (E, 3Hg)``, ``bi (1, 3Hg)``,
    ``Wh = [hr | hz | hn] (Hg, 3Hg)``, ``bhn (1, Hg)``,
    ``Wc = [policy | value | message] (Hg, A+1+M)``, ``bc (1, A+1+M)``: the
    fused gate matrices of ``ippo_rnn.py:494-512``, each kernel (in, out) as
    flax keeps it."""

    obs_len: int
    embed: int
    hidden: int
    n_actions: int = 5
    msg_bits: int = 0

    @property
    def shapes(self) -> List[Tuple[int, int]]:
        e, hg, ac = self.embed, self.hidden, self.n_actions + 1 + self.msg_bits
        return [(self.obs_len, e), (1, e), (e, 3 * hg), (1, 3 * hg), (hg, 3 * hg), (1, hg),
                (hg, ac), (1, ac)]

    @staticmethod
    def of(model: "RecurrentActorCritic") -> "GruDims":
        return GruDims(model.obs_dim, model.embed_dim, model.hidden, model.n_actions,
                       model.msg_bits)


GRU_INPUT_GATES, GRU_HIDDEN_GATES = ("ir", "iz", "in"), ("hr", "hz", "hn")


class RecurrentActorCritic(nn.Module):
    """GRU actor-critic (the counterpart of the flax ``RecurrentActorCritic``):
    ``forward(carry, obs) -> (carry, (logits, value))`` consumes one timestep
    of obs (..., L) with the carry (..., hidden) in bf16, in flax's rounding
    (:func:`gru_apply_step`); with ``msg_bits`` the logits are ``(logits,
    msg_logits)``.

    The GRU's six matrices are kept as flax's ``GRUCell`` names them:
    ``ir``, ``iz``, ``in`` with a bias, ``hr``, ``hz`` without, ``hn`` with."""

    def __init__(self, obs_dim: int, n_actions: int = 5, hidden: int = 128, embed: int = 128,
                 msg_bits: int = 0):
        super().__init__()
        self.obs_dim, self.n_actions, self.msg_bits = obs_dim, n_actions, msg_bits
        self.hidden, self.embed_dim = hidden, embed
        self.embed = nn.Linear(obs_dim, embed)
        self.gru = nn.ModuleDict({
            **{k: nn.Linear(embed, hidden) for k in GRU_INPUT_GATES},
            **{k: nn.Linear(hidden, hidden, bias=(k == "hn")) for k in GRU_HIDDEN_GATES},
        })
        self.policy = nn.Linear(hidden, n_actions)
        self.value = nn.Linear(hidden, 1)
        if msg_bits:
            self.message = nn.Linear(hidden, msg_bits)

    def initialize_carry(self, batch_shape: Tuple[int, ...], device=None) -> torch.Tensor:
        """The zero carry ``batch_shape + (hidden,)`` in bf16."""
        device = self.embed.weight.device if device is None else device
        return torch.zeros(tuple(batch_shape) + (self.hidden,), dtype=torch.bfloat16,
                           device=device)

    def forward(self, carry: torch.Tensor, obs: torch.Tensor):
        new_h, heads, value = gru_apply_step(gru_to_arrays(self), carry, obs, self.msg_bits)
        return new_h, (heads, value)


def gru_to_arrays(model: "RecurrentActorCritic") -> List[torch.Tensor]:
    """The eight :class:`GruDims` blocks of ``model``."""
    g = model.gru
    heads = head_layers(model)
    return [
        model.embed.weight.t(), model.embed.bias[None, :],
        torch.cat([g[k].weight.t() for k in GRU_INPUT_GATES], 1),
        torch.cat([g[k].bias for k in GRU_INPUT_GATES])[None, :],
        torch.cat([g[k].weight.t() for k in GRU_HIDDEN_GATES], 1), g["hn"].bias[None, :],
        torch.cat([h.weight for h in heads], 0).t(),
        torch.cat([h.bias for h in heads], 0)[None, :],
    ]


@torch.no_grad()
def arrays_to_gru(arrays: Sequence[torch.Tensor], model: Optional["RecurrentActorCritic"] = None,
                  msg_bits: int = 0) -> "RecurrentActorCritic":
    """Copy the eight blocks into ``model`` (a new one with ``msg_bits`` on
    the blocks' device if None) and return it."""
    we, be, wi, bi, wh, bhn, wc, bc = arrays
    hg = wh.shape[0]
    if model is None:
        model = RecurrentActorCritic(we.shape[0], wc.shape[1] - 1 - msg_bits, hg, we.shape[1],
                                     msg_bits).to(we.device)
    model.embed.weight.copy_(we.t())
    model.embed.bias.copy_(be[0])
    for q, (ki, kh) in enumerate(zip(GRU_INPUT_GATES, GRU_HIDDEN_GATES)):
        model.gru[ki].weight.copy_(wi[:, q * hg:(q + 1) * hg].t())
        model.gru[ki].bias.copy_(bi[0, q * hg:(q + 1) * hg])
        model.gru[kh].weight.copy_(wh[:, q * hg:(q + 1) * hg].t())
    model.gru["hn"].bias.copy_(bhn[0])
    _copy_heads(model, wc, bc)
    return model


def init_recurrent_actor_critic(obs_dim: int, n_actions: int = 5, hidden: int = 128,
                                embed: int = 128, seed: int = 0,
                                msg_bits: int = 0) -> "RecurrentActorCritic":
    """A :class:`RecurrentActorCritic` with flax's default init, drawn from
    ``numpy.random.default_rng(seed)``: LeCun-normal kernels for ``embed``,
    ``ir``, ``iz``, ``in`` and the heads (see :func:`init_actor_critic`),
    orthogonal ``hr``, ``hz``, ``hn`` (the Q of a normal matrix's QR with the
    signs of R's diagonal, as ``jax.nn.initializers.orthogonal``), biases
    zero.  The same distributions as flax's, not the same numbers."""
    model = RecurrentActorCritic(obs_dim, n_actions, hidden, embed, msg_bits)
    rng = np.random.default_rng(seed)
    g = model.gru
    _flax_dense_init([model.embed] + [g[k] for k in GRU_INPUT_GATES] + head_layers(model), rng)
    with torch.no_grad():
        for k in GRU_HIDDEN_GATES:
            q, r = np.linalg.qr(rng.standard_normal((hidden, hidden)))
            q = q * np.sign(np.diag(r))[None, :]
            g[k].weight.copy_(torch.from_numpy(q.T.copy()))
        g["hn"].bias.zero_()
    return model


def split_gates(x: torch.Tensor):
    hg = x.shape[-1] // 3
    return x[..., :hg], x[..., hg:2 * hg], x[..., 2 * hg:]


def gru_collect_step(arrays: Sequence[torch.Tensor], h: torch.Tensor, obs: torch.Tensor,
                     msg_bits: int = 0):
    """One step in the fused collector's rounding
    (``pallas_rollout.py::_gru_forward``): ``h`` (M, Hg) and ``obs`` (M, L)
    hold bf16 values; returns (logits (M, A) f32, value (M,) f32, new_h (M,
    Hg) float32 holding bf16 values), the logits ``(logits, msg_logits)``
    with ``msg_bits``.  With a leading axis of N stacks on every array
    (``h`` (N, M, Hg), ``obs`` (N, M, L), the blocks (N, ...)) it runs the N
    cells at once, each output the one-stack call's.

    Input and hidden products are summed separately in float32 and added
    before the sigmoid; the candidate adds two bf16-rounded terms in bf16;
    the heads are float32 on float32 weights.  Every product runs in the
    fixed order of :func:`ordered_matmul` and the sigmoid is
    :func:`sigmoid_f32`, so the collector kernel reproduces it bit for bit."""
    we, be, wi, bi, wh, bhn, wc, bc = (a.float() for a in arrays)
    hb = h.float()
    e = bf16_tanh(ordered_matmul(rnd_bf16(obs.float()), rnd_bf16(we)) + be)
    gi_r, gi_z, gi_n = split_gates(ordered_matmul(e, rnd_bf16(wi)))
    gh_r, gh_z, gh_n = split_gates(ordered_matmul(hb, rnd_bf16(wh)))
    bi_r, bi_z, bi_n = split_gates(bi)
    r = rnd_bf16(sigmoid_f32((gi_r + gh_r) + bi_r))
    z = rnd_bf16(sigmoid_f32((gi_z + gh_z) + bi_z))
    n = rnd_bf16(torch.tanh(rnd_bf16(rnd_bf16(gi_n + bi_n) + rnd_bf16(r * rnd_bf16(gh_n + bhn)))))
    new_h = rnd_bf16(rnd_bf16(rnd_bf16(1.0 - z) * n) + rnd_bf16(z * hb))
    heads, value = split_heads(ordered_matmul(new_h, wc) + bc, msg_bits)
    return heads, value, new_h


def gru_embed_gates(arrays: Sequence[torch.Tensor], obs: torch.Tensor):
    """The time-parallel half of the sequence kernels' cell
    (``pallas_gru.py:451-463``): ``e = bf16(tanh(bf16(obs We + be)))`` and the
    fused input gates ``iall = bf16(e Wi + bi)`` of obs (..., L), both as
    float32 holding bf16 values.  Differentiable; the roundings pass the
    gradient through."""
    we, be, wi, bi = arrays[:4]
    e = bf16_round(torch.tanh(bf16_round(obs.float() @ bf16_round(we) + be[0])))
    return e, bf16_round(e @ bf16_round(wi) + bi[0])


def gru_replay_cell(wh: torch.Tensor, bhn: torch.Tensor, h: torch.Tensor, iall: torch.Tensor):
    """The sequential half (``pallas_gru.py:467-486``): the new hidden (...,
    Hg) from the previous one and the bf16 input gates.  ``iall`` is rounded
    to bf16 BEFORE the gate sums (the collector's cell rounds after), and r,
    z and the candidate's terms are bf16."""
    hh_r, hh_z, hh_n = split_gates(h @ bf16_round(wh))
    ia_r, ia_z, ia_n = split_gates(iall)
    r = bf16_round(sigmoid_f32(ia_r + hh_r))
    z = bf16_round(sigmoid_f32(ia_z + hh_z))
    n = bf16_round(torch.tanh(bf16_round(ia_n + bf16_round(r * bf16_round(hh_n + bhn[0])))))
    return bf16_round(bf16_round(bf16_round(1.0 - z) * n) + bf16_round(z * h))


def gru_replay_step(arrays: Sequence[torch.Tensor], h: torch.Tensor, obs: torch.Tensor):
    """One step in the sequence kernels' rounding: new hidden (..., Hg) as
    float32 holding bf16 values, from ``h`` (..., Hg) and ``obs`` (..., L).
    Differentiable (``arrays`` are the first six :class:`GruDims` blocks)."""
    _, iall = gru_embed_gates(arrays, obs)
    return gru_replay_cell(arrays[4], arrays[5], h.float(), iall)


def gru_replay_heads(wc: torch.Tensor, bc: torch.Tensor, hseq: torch.Tensor, msg_bits: int = 0,
                     round_grads: bool = True):
    """(logits, value) from the bf16 hidden sequence as the replay computes
    them (``ippo_rnn.py:546-560``): head weights rounded to bf16, float32
    sums, float32 biases; the logits are ``(logits, msg_logits)`` with
    ``msg_bits``.  The collector's heads keep float32 weights.  The head
    weights' gradient is rounded to bf16 (:func:`bf16_param`); with
    ``round_grads=False`` it stays float32 and the caller rounds it
    (:func:`round_grad_blocks`, block 6 of :class:`GruDims`) once the whole
    batch's sum is taken."""
    w = bf16_param(wc) if round_grads else bf16_round(wc)
    return split_heads(hseq.float() @ w + bc[0], msg_bits)


def gru_apply_step(arrays: Sequence[torch.Tensor], h: torch.Tensor, obs: torch.Tensor,
                   msg_bits: int = 0):
    """One step of the flax module itself (``Dense`` and ``GRUCell`` with
    ``dtype=bfloat16``): every product, bias add, gate sum and activation
    rounded to bf16 (the sigmoid as XLA expands it in bf16: ``exp``, the add
    and the division each rounded), float32 heads on the bf16 hidden.  The learners'
    bootstrap value (``model.apply`` at ``ippo_rnn.py:823-825``) and
    ``evaluate`` read it.  Returns (new_h bf16, logits f32, value f32) with
    the leading shape of ``obs``, the logits ``(logits, msg_logits)`` with
    ``msg_bits``."""
    we, be, wi, bi, wh, bhn, wc, bc = (a.float() for a in arrays)
    lead = obs.shape[:-1]
    hb = h.float().reshape(-1, h.shape[-1])
    x = rnd_bf16(obs.float().reshape(-1, obs.shape[-1]))

    def dense(v, w, b=None):
        out = rnd_bf16(v @ rnd_bf16(w))
        return out if b is None else rnd_bf16(out + rnd_bf16(b))

    e = rnd_bf16(torch.tanh(dense(x, we, be)))
    gi_r, gi_z, gi_n = split_gates(dense(e, wi, bi))
    gh_r, gh_z, gh_n = split_gates(dense(hb, wh))
    def sigmoid(v):  # XLA expands a bf16 logistic op by op: exp, add and divide each round
        return rnd_bf16(1.0 / rnd_bf16(1.0 + rnd_bf16(torch.exp(-v))))

    r = sigmoid(rnd_bf16(gi_r + gh_r))
    z = sigmoid(rnd_bf16(gi_z + gh_z))
    n = rnd_bf16(torch.tanh(rnd_bf16(gi_n + rnd_bf16(r * rnd_bf16(gh_n + rnd_bf16(bhn))))))
    new_h = rnd_bf16(rnd_bf16(rnd_bf16(1.0 - z) * n) + rnd_bf16(z * hb))
    heads, value = split_heads((new_h @ wc + bc).reshape(lead + (wc.shape[1],)), msg_bits)
    return new_h.to(torch.bfloat16).reshape(lead + (new_h.shape[-1],)), heads, value
