"""Policy/value network (the counterpart of ``rware_tpu/models/networks.py``,
forward only).

``ActorCritic`` follows the numerics recipe of the fused collector
(``rware_tpu/ops/pallas_rollout.py::_policy_forward``): bf16 inputs and
weights, f32 accumulation, the f32 bias added, the sum rounded to bf16 and
tanh taken on that bf16 value; the f32 heads read the bf16 hidden.

Every product is accumulated in one fixed order — input feature 0 first,
one rounded multiply and one rounded add per term, no fused multiply-add —
which is the order the fused collector kernel (``csrc/fused_collect.cu``)
uses, so on the card the two agree bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn


def ordered_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T + bias`` in float32, summed over the input features in
    ascending order with separately rounded multiplies and adds.

    ``x`` (M, K) and ``weight`` (J, K) hold float32 values (bf16-exact where
    the recipe calls for bf16)."""
    acc = torch.zeros((x.shape[0], weight.shape[0]), dtype=torch.float32, device=x.device)
    w_t = weight.t()
    for k in range(x.shape[1]):
        acc = acc + x[:, k : k + 1] * w_t[k]
    return acc + bias


def bf16_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh of the bf16-rounded ``x``, rounded to bf16 (returned as float32)."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    return torch.tanh(xb).to(torch.bfloat16).to(torch.float32)


class ActorCritic(nn.Module):
    """Shared-parameter MLP actor-critic: obs (..., L) -> (logits (..., A)
    f32, value (...,) f32).  Parameters are float32 (as flax keeps them);
    the forward casts the hidden layers' weights to bf16."""

    def __init__(self, obs_dim: int, n_actions: int = 5,
                 hidden: Sequence[int] = (128, 128)):
        super().__init__()
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        self.hidden = tuple(hidden)
        widths = (obs_dim,) + self.hidden
        self.dense = nn.ModuleList(
            nn.Linear(widths[i], widths[i + 1]) for i in range(len(self.hidden))
        )
        self.policy = nn.Linear(widths[-1], n_actions)
        self.value = nn.Linear(widths[-1], 1)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        lead = obs.shape[:-1]
        x = obs.reshape(-1, obs.shape[-1]).to(torch.bfloat16).to(torch.float32)
        for layer in self.dense:
            w = layer.weight.to(torch.bfloat16).to(torch.float32)
            x = bf16_tanh(ordered_linear(x, w, layer.bias.float()))
        logits = ordered_linear(x, self.policy.weight.float(), self.policy.bias.float())
        value = ordered_linear(x, self.value.weight.float(), self.value.bias.float())
        return logits.reshape(lead + (self.n_actions,)), value.reshape(lead)


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
