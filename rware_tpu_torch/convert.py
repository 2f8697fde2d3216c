"""Converters between the JAX package's data (as numpy) and the port's.

* flax ``ActorCritic`` params pytree  <->  :class:`ActorCritic` weights.
  flax keeps a Dense kernel as (in, out); ``nn.Linear`` keeps (out, in).
  A ``message`` Dense (``msg_bits`` > 0) joins the head block after the
  value, in every converter of an actor (MLP or GRU).
* a ``WarehouseState``'s fields as numpy arrays (batched, leading env axis)
  <->  :class:`WarehouseState`.  The JAX state's per-env ``key`` has no
  counterpart and is dropped; callers keep their own.
* flax params pytree  <->  the learners' flat parameter vector
  (:class:`~rware_tpu_torch.models.networks.BlockDims` layout), and the
  optax state of ``chain(clip_by_global_norm, adam(...))`` (``count``,
  ``mu``, ``nu``, and the schedule's ``count`` when the lr anneals)  <->
  :class:`~rware_tpu_torch.models.ppo.AdamState`.
* MAPPO: the flax ``CentralCritic`` pytree  <->  :class:`CentralCritic`
  weights and the critic's flat vector
  (:class:`~rware_tpu_torch.models.networks.CriticDims` layout; dense_0 keeps
  flax's agent-major row order), and the split optimizer state
  ``{"actor", "critic"}`` of ``make_mappo_optimizer``  <->  two ``AdamState``.
* recurrent IPPO: the flax ``RecurrentActorCritic`` pytree (``embed``, the
  ``gru`` cell's ``ir iz in hr hz hn``, ``policy``, ``value``)  <->
  :class:`RecurrentActorCritic` weights and the flat vector in the
  :class:`~rware_tpu_torch.models.networks.GruDims` layout.
* SEAC: the stacked flax ``ActorCritic`` pytree of ``init_seac`` (a leading
  agent axis on every leaf)  <->  the ``(N, P)`` stack of flat vectors, and
  the one optax chain over that stack  <->  one ``AdamState`` of ``(N, P)``
  moments.

Nothing here imports jax: the JAX side is handed over as numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from rware_tpu_torch.core.state import WarehouseState, state_field_names
from rware_tpu_torch.models.networks import (
    ActorCritic,
    BlockDims,
    CentralCritic,
    CriticDims,
    GruDims,
    RecurrentActorCritic,
    head_layers,
    arrays_to_critic,
    arrays_to_gru,
    pack_arrays,
)
from rware_tpu_torch.models.ppo import AdamState

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
        msg_bits=_msg_bits(p),
    )
    layers = list(model.dense) + head_layers(model)
    names = [f"dense_{i}" for i in range(n_hidden)] + list(_head_names(p))
    with torch.no_grad():
        for layer, name in zip(layers, names):
            kernel = np.asarray(p[name]["kernel"], dtype=np.float32)
            layer.weight.copy_(torch.from_numpy(kernel.T.copy()))
            layer.bias.copy_(torch.from_numpy(np.array(p[name]["bias"], dtype=np.float32)))
    return model.to(device)


def actor_critic_to_flax(model: ActorCritic) -> Dict[str, Any]:
    """The flax params pytree (numpy float32 leaves) of ``model``."""
    layers = {f"dense_{i}": layer for i, layer in enumerate(model.dense)}
    layers.update(zip(("policy", "value", "message"), head_layers(model)))
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


def _tree(params: Mapping[str, Any]) -> Mapping[str, Any]:
    return params["params"] if "params" in params else params


def _msg_bits(p: Mapping[str, Any]) -> int:
    """Message bits of a flax actor tree: the width of its ``message`` head."""
    return int(np.shape(p["message"]["kernel"])[1]) if "message" in p else 0


def _head_names(p: Mapping[str, Any]):
    return ("policy", "value") + (("message",) if "message" in p else ())


def _head_blocks(p: Mapping[str, Any]) -> list:
    """The head block ``[policy | value | message]`` and its bias row."""
    names = _head_names(p)
    return [np.concatenate([p[k]["kernel"] for k in names], axis=1),
            np.concatenate([p[k]["bias"] for k in names])[None, :]]


def _heads_to_flax(wc: np.ndarray, bc: np.ndarray, n_actions: int, msg_bits: int) -> dict:
    """The flax head Denses of a head block (the inverse of :func:`_head_blocks`)."""
    a = n_actions
    out = {"policy": {"kernel": wc[:, :a].copy(), "bias": bc[0, :a].copy()},
           "value": {"kernel": wc[:, a:a + 1].copy(), "bias": bc[0, a:a + 1].copy()}}
    if msg_bits:
        out["message"] = {"kernel": wc[:, a + 1:].copy(), "bias": bc[0, a + 1:].copy()}
    return out


def params_from_flax(params: Mapping[str, Any], device="cpu") -> torch.Tensor:
    """The flat parameter vector of a flax ActorCritic params pytree (or of
    an optax moment pytree of the same structure)."""
    p = _tree(params)
    blocks = [
        p["dense_0"]["kernel"], np.asarray(p["dense_0"]["bias"])[None, :],
        p["dense_1"]["kernel"], np.asarray(p["dense_1"]["bias"])[None, :],
        *_head_blocks(p),
    ]
    arrays = [torch.from_numpy(np.array(b, dtype=np.float32)) for b in blocks]
    return pack_arrays(arrays).to(device)


def params_to_flax(flat: torch.Tensor, dims: BlockDims) -> Dict[str, Any]:
    """The flax params pytree (numpy float32 leaves) of a flat vector."""
    w0, b0, w1, b1, wc, bc = (a.detach().cpu().numpy() for a in dims.split(flat))
    return {
        "params": {
            "dense_0": {"kernel": w0.copy(), "bias": b0[0].copy()},
            "dense_1": {"kernel": w1.copy(), "bias": b1[0].copy()},
            **_heads_to_flax(wc, bc, dims.n_actions, dims.msg_bits),
        }
    }


def gru_params_from_flax(params: Mapping[str, Any], device="cpu") -> torch.Tensor:
    """The flat parameter vector (:class:`GruDims` layout) of a flax
    RecurrentActorCritic params pytree (or of an optax moment pytree of the
    same structure)."""
    p = _tree(params)
    g = p["gru"]
    blocks = [
        p["embed"]["kernel"], np.asarray(p["embed"]["bias"])[None, :],
        np.concatenate([g[k]["kernel"] for k in ("ir", "iz", "in")], axis=1),
        np.concatenate([g[k]["bias"] for k in ("ir", "iz", "in")])[None, :],
        np.concatenate([g[k]["kernel"] for k in ("hr", "hz", "hn")], axis=1),
        np.asarray(g["hn"]["bias"])[None, :],
        *_head_blocks(p),
    ]
    return pack_arrays([torch.from_numpy(np.array(b, dtype=np.float32)) for b in blocks]).to(device)


def gru_params_to_flax(flat: torch.Tensor, dims: GruDims) -> Dict[str, Any]:
    """The flax RecurrentActorCritic params pytree (numpy float32 leaves) of
    a flat vector."""
    we, be, wi, bi, wh, bhn, wc, bc = (a.detach().cpu().numpy() for a in dims.split(flat))
    hg = dims.hidden
    gru = {}
    for q, (ki, kh) in enumerate((("ir", "hr"), ("iz", "hz"), ("in", "hn"))):
        cols = slice(q * hg, (q + 1) * hg)
        gru[ki] = {"kernel": wi[:, cols].copy(), "bias": bi[0, cols].copy()}
        gru[kh] = {"kernel": wh[:, cols].copy()}
    gru["hn"]["bias"] = bhn[0].copy()
    return {
        "params": {
            "embed": {"kernel": we.copy(), "bias": be[0].copy()},
            "gru": gru,
            **_heads_to_flax(wc, bc, dims.n_actions, dims.msg_bits),
        }
    }


def recurrent_from_flax(params: Mapping[str, Any], device="cpu") -> RecurrentActorCritic:
    """Build a :class:`RecurrentActorCritic` from a flax params pytree."""
    p = _tree(params)
    dims = GruDims(np.shape(p["embed"]["kernel"])[0], np.shape(p["embed"]["kernel"])[1],
                   np.shape(p["gru"]["hr"]["kernel"])[0], np.shape(p["policy"]["kernel"])[1],
                   _msg_bits(p))
    return arrays_to_gru(dims.split(gru_params_from_flax(params)), msg_bits=dims.msg_bits
                         ).to(device)


def critic_params_from_flax(params: Mapping[str, Any], device="cpu") -> torch.Tensor:
    """The flat parameter vector of a flax CentralCritic params pytree (or of
    an optax moment pytree of the same structure)."""
    p = _tree(params)
    blocks = [np.asarray(p[name][leaf]) for name in ("dense_0", "dense_1", "value")
              for leaf in ("kernel", "bias")]
    return pack_arrays([torch.from_numpy(np.array(b, dtype=np.float32)) for b in blocks]).to(device)


def critic_params_to_flax(flat: torch.Tensor, cdims: CriticDims) -> Dict[str, Any]:
    """The flax CentralCritic params pytree (numpy float32 leaves) of a flat vector."""
    c0, cb0, c1, cb1, cv, cbv = (a.detach().cpu().numpy() for a in cdims.split(flat))
    return {
        "params": {
            "dense_0": {"kernel": c0.copy(), "bias": cb0[0].copy()},
            "dense_1": {"kernel": c1.copy(), "bias": cb1[0].copy()},
            "value": {"kernel": cv.copy(), "bias": cbv[0].copy()},
        }
    }


def central_critic_from_flax(params: Mapping[str, Any], device="cpu") -> CentralCritic:
    """Build a :class:`CentralCritic` from a flax params pytree
    (``{"params": {"dense_0", "dense_1", "value"}}``)."""
    p = _tree(params)
    joint, n = np.shape(p["dense_0"]["kernel"])[0], np.shape(p["value"]["kernel"])[1]
    cdims = CriticDims(n, joint // n, *(np.shape(p[f"dense_{i}"]["kernel"])[1] for i in range(2)))
    return arrays_to_critic(cdims.split(critic_params_from_flax(params))).to(device)


def _agent_slice(tree: Any, i: int) -> Any:
    """Leaf ``[i]`` of every leaf of a nested mapping of arrays."""
    if isinstance(tree, Mapping):
        return {k: _agent_slice(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _agent_stack(trees) -> Dict[str, Any]:
    """The nested mappings of ``trees`` stacked leaf by leaf on a new axis 0."""
    if isinstance(trees[0], Mapping):
        return {k: _agent_stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def seac_params_from_flax(params: Mapping[str, Any], device="cpu") -> torch.Tensor:
    """The (N, P) stack of flat vectors of a stacked flax ActorCritic params
    pytree (``init_seac``: a leading agent axis on every leaf) or of a stacked
    RecurrentActorCritic one (``init_seac_gru``, :class:`GruDims` rows), or of
    an optax moment pytree of the same structure."""
    p = _tree(params)
    from_flax = gru_params_from_flax if "gru" in p else params_from_flax
    n = np.shape(p["policy"]["kernel"])[0]
    return torch.stack([from_flax(_agent_slice(p, i)) for i in range(n)]).to(device)


def seac_params_to_flax(stack: torch.Tensor, dims) -> Dict[str, Any]:
    """The stacked flax params pytree (numpy float32 leaves) of an (N, P)
    stack of :class:`BlockDims` or :class:`GruDims` rows."""
    to_flax = gru_params_to_flax if isinstance(dims, GruDims) else params_to_flax
    return {"params": _agent_stack([to_flax(row, dims)["params"] for row in stack])}


def seac_opt_state_from_optax(opt_state: Any, device="cpu") -> AdamState:
    """:class:`AdamState` of (N, P) moments of the optax state of SEAC's
    ``chain(clip_by_global_norm, adam)`` over the stacked pytree, MLP or GRU,
    message head included (``rware_tpu/models/seac.py:78-82, 783-786``)."""
    return adam_state_from_optax(opt_state, device, seac_params_from_flax)


def seac_opt_state_to_optax(state: AdamState, dims, like: Any) -> Any:
    """The optax state of ``state``, in the structure of ``like``."""
    return adam_state_to_optax(state, dims, like, seac_params_to_flax)


def adam_state_from_optax(opt_state: Any, device="cpu", from_flax=params_from_flax) -> AdamState:
    """:class:`AdamState` of the optax state of the learners' optimizer
    (``rware_tpu/models/ippo.py:241-246``), its leaves as numpy arrays;
    ``from_flax`` flattens the moment pytrees."""
    adam = opt_state[1][0]
    return AdamState(int(adam.count), from_flax(adam.mu, device), from_flax(adam.nu, device))


def mappo_params_from_flax(params: Mapping[str, Any], device="cpu",
                           actor_from_flax=params_from_flax) -> Dict[str, torch.Tensor]:
    """``{"actor", "critic"}`` flat vectors of MAPPO's flax params; recurrent
    MAPPO's GRU actor (``mappo.py:706-755``) takes
    ``actor_from_flax=gru_params_from_flax``."""
    return {"actor": actor_from_flax(params["actor"], device),
            "critic": critic_params_from_flax(params["critic"], device)}


def mappo_opt_state_from_optax(opt_state: Mapping[str, Any], device="cpu",
                               actor_from_flax=params_from_flax) -> Dict[str, AdamState]:
    """``{"actor", "critic"}`` :class:`AdamState` of the split optax state of
    ``make_mappo_optimizer`` (``rware_tpu/models/mappo.py:120-150``); the
    actor's moments in the layout of ``actor_from_flax`` (recurrent MAPPO:
    ``gru_params_from_flax``)."""
    return {"actor": adam_state_from_optax(opt_state["actor"], device, actor_from_flax),
            "critic": adam_state_from_optax(opt_state["critic"], device,
                                            critic_params_from_flax)}


def mappo_opt_state_to_optax(state: Mapping[str, AdamState], dims, cdims: CriticDims,
                             like: Mapping[str, Any],
                             actor_to_flax=params_to_flax) -> Dict[str, Any]:
    """The split optax state of ``state``, in the structure of ``like``;
    ``dims`` is a :class:`BlockDims` or, with ``actor_to_flax=
    gru_params_to_flax``, a :class:`GruDims`."""
    return {"actor": adam_state_to_optax(state["actor"], dims, like["actor"], actor_to_flax),
            "critic": adam_state_to_optax(state["critic"], cdims, like["critic"],
                                          critic_params_to_flax)}


def adam_state_to_optax(state: AdamState, dims, like: Any, to_flax=params_to_flax) -> Any:
    """The optax state of ``state``, in the structure of ``like`` (an optax
    state of the same optimizer); the schedule's count, where ``like`` has
    one, advances with Adam's.  ``to_flax(flat, dims)`` rebuilds the moment
    pytrees."""
    count = np.asarray(state.count, dtype=np.int32)
    adam = like[1][0]._replace(count=count, mu=to_flax(state.mu, dims),
                               nu=to_flax(state.nu, dims))
    sched = like[1][1]
    if "count" in getattr(sched, "_fields", ()):
        sched = sched._replace(count=count)
    return (like[0], (adam, sched))
