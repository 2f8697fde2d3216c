"""Converters between the JAX package's data (as numpy) and the port's.

* flax ``ActorCritic`` params pytree  <->  :class:`ActorCritic` weights.
  flax keeps a Dense kernel as (in, out); ``nn.Linear`` keeps (out, in).
* a ``WarehouseState``'s fields as numpy arrays (batched, leading env axis)
  <->  :class:`WarehouseState`.  The JAX state's per-env ``key`` has no
  counterpart and is dropped; callers keep their own.

Nothing here imports jax: the JAX side is handed over as numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from rware_tpu_torch.core.state import WarehouseState, state_field_names
from rware_tpu_torch.models.networks import ActorCritic

_STATE_DTYPES = {
    "agent_has_delivered": torch.bool,
    "agent_message": torch.float32,
}


def actor_critic_from_flax(params: Mapping[str, Any], device="cpu") -> ActorCritic:
    """Build an :class:`ActorCritic` from a flax params pytree
    (``{"params": {"dense_0": {"kernel", "bias"}, ..., "policy", "value"}}``)."""
    p = params["params"] if "params" in params else params
    n_hidden = sum(1 for k in p if k.startswith("dense_"))
    kernels = [np.asarray(p[f"dense_{i}"]["kernel"]) for i in range(n_hidden)]
    policy_k = np.asarray(p["policy"]["kernel"])
    model = ActorCritic(
        obs_dim=kernels[0].shape[0],
        n_actions=policy_k.shape[1],
        hidden=tuple(k.shape[1] for k in kernels),
    )
    layers = list(model.dense) + [model.policy, model.value]
    names = [f"dense_{i}" for i in range(n_hidden)] + ["policy", "value"]
    with torch.no_grad():
        for layer, name in zip(layers, names):
            kernel = np.asarray(p[name]["kernel"], dtype=np.float32)
            layer.weight.copy_(torch.from_numpy(kernel.T.copy()))
            layer.bias.copy_(torch.from_numpy(np.array(p[name]["bias"], dtype=np.float32)))
    return model.to(device)


def actor_critic_to_flax(model: ActorCritic) -> Dict[str, Any]:
    """The flax params pytree (numpy float32 leaves) of ``model``."""
    layers = {f"dense_{i}": layer for i, layer in enumerate(model.dense)}
    layers.update(policy=model.policy, value=model.value)
    return {
        "params": {
            name: {
                "kernel": layer.weight.detach().cpu().numpy().T.copy(),
                "bias": layer.bias.detach().cpu().numpy().copy(),
            }
            for name, layer in layers.items()
        }
    }


def state_from_numpy(fields: Any, device="cpu") -> WarehouseState:
    """A :class:`WarehouseState` from batched arrays: a mapping of field
    name -> array, or any object with those attributes (e.g. the JAX
    package's state).  Extra fields such as ``key`` are ignored."""
    get = fields.__getitem__ if isinstance(fields, Mapping) else lambda k: getattr(fields, k)
    out = {}
    for name in state_field_names():
        arr = torch.from_numpy(np.array(get(name)))  # a writable copy
        out[name] = arr.to(device=device, dtype=_STATE_DTYPES.get(name, torch.int32))
    return WarehouseState(**out)


def state_to_numpy(state: WarehouseState) -> Dict[str, np.ndarray]:
    """Field name -> numpy array (int32 / bool / float32, as in JAX)."""
    return {name: getattr(state, name).cpu().numpy() for name in state_field_names()}
