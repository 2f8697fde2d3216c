"""Host views of device results, without gymnasium.

:func:`to_host` brings any number of tensors to numpy through ONE
device-to-host copy: their bytes are packed into one buffer on their device,
copied once, and split on the host.  :func:`step_to_host` does that for a
step's observations, rewards, done, truncated and info, and the ``convert_*``
functions rebuild the reference's per-agent observation layouts from them
(``rware_tpu/gym_adapter.py:177-247``, ``rware_tpu/vector.py:122-177``).
:class:`HostEnv` and :class:`HostVectorEnv` step one env and a batch with
numpy in and out; the Gymnasium classes of :mod:`rware_tpu_torch.gym_adapter`
and :mod:`rware_tpu_torch.vector` are thin shells over them, and a machine
without gymnasium runs them alone.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.core.state import WarehouseState, state_field_names
from rware_tpu_torch.types import ObservationType

_NUMPY = {
    torch.float32: np.float32,
    torch.float64: np.float64,
    torch.int64: np.int64,
    torch.int32: np.int32,
    torch.int16: np.int16,
    torch.int8: np.int8,
    torch.uint8: np.uint8,
    torch.bool: np.bool_,
}
_ALIGN = 8  # every tensor's bytes start at a multiple of 8 in the buffer


def to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """numpy copies of ``tensors`` (all on one device) through one
    device-to-host copy."""
    parts, layout = [], []
    for t in tensors:
        flat = t.detach().reshape(-1).contiguous().view(torch.uint8)
        pad = -flat.numel() % _ALIGN
        parts.append(flat)
        if pad:
            parts.append(flat.new_zeros(pad))
        layout.append((t.shape, _NUMPY[t.dtype], flat.numel(), pad))
    if not parts:
        return []
    buf = torch.cat(parts).cpu().numpy()
    out, off = [], 0
    for shape, dtype, n, pad in layout:
        out.append(buf[off:off + n].view(dtype).reshape(tuple(shape)))
        off += n + pad
    return out


def env_to_host(state: WarehouseState, env: int = 0,
                fields: Sequence[str] = state_field_names()) -> Dict[str, np.ndarray]:
    """Field name -> numpy array of env ``env`` of a batched state, in one copy."""
    return dict(zip(fields, to_host(*(getattr(state, f)[env] for f in fields))))


def step_to_host(obs: Any, rewards: torch.Tensor, done: torch.Tensor,
                 truncated: torch.Tensor, info: Dict[str, torch.Tensor]) -> Tuple:
    """``(obs, rewards, done, truncated, info)`` of a batched step as numpy,
    in one copy; ``obs`` stays a dict of arrays where it was one
    (IMAGE_DICT)."""
    keys = list(obs) if isinstance(obs, dict) else None
    leaves = [obs[k] for k in keys] if keys else [obs]
    host = to_host(*leaves, rewards, done, truncated, *info.values())
    obs_np = dict(zip(keys, host[:len(keys)])) if keys else host[0]
    k = len(leaves)
    return (obs_np, host[k], host[k + 1], host[k + 2],
            dict(zip(info.keys(), host[k + 3:])))


# -- the reference's observation layouts ------------------------------------------


def flat_to_dict(config: WarehouseConfig, flat: np.ndarray) -> dict:
    """Rebuild the reference's nested DICT obs from one flat vector
    (inverse of the _VectorWriter layout, rware/warehouse.py:631-674)."""
    i = 0

    def take(k):
        nonlocal i
        out = flat[i : i + k]
        i += k
        return out

    loc = take(2)
    if not config.normalised_coordinates:
        loc = loc.astype(np.int32)
    obs = {
        "self": {
            "location": loc,
            "carrying_shelf": [int(take(1)[0])],
            "direction": int(np.argmax(take(4))),
            "on_highway": [int(take(1)[0])],
        }
    }
    sensors = []
    for _ in range(config.n_sensor_cells):
        cell = OrderedDict()
        cell["has_agent"] = [int(take(1)[0])]
        cell["direction"] = int(np.argmax(take(4)))
        # The reference also emits "local_message": None when msg_bits == 0
        # (warehouse.py:700-702); modern gymnasium Dict.contains rejects
        # the extra key, so it is omitted here unless msg_bits > 0.
        if config.msg_bits > 0:
            cell["local_message"] = [int(b) for b in take(config.msg_bits)]
        cell["has_shelf"] = [int(take(1)[0])]
        cell["shelf_requested"] = [int(take(1)[0])]
        sensors.append(cell)
    obs["sensors"] = tuple(sensors)
    return obs


def flat_to_dict_batch(config: WarehouseConfig, flat: np.ndarray) -> dict:
    """Vectorised :func:`flat_to_dict` over a ``(B, L)`` flat block."""
    i = 0

    def take(k):
        nonlocal i
        out = flat[:, i : i + k]
        i += k
        return out

    loc = take(2)
    if not config.normalised_coordinates:
        loc = loc.astype(np.int32)
    as_bin = lambda a: a.astype(np.int8)
    obs = {
        "self": {
            "location": loc,
            "carrying_shelf": as_bin(take(1)),
            "direction": np.argmax(take(4), axis=1).astype(np.int64),
            "on_highway": as_bin(take(1)),
        }
    }
    sensors = []
    for _ in range(config.n_sensor_cells):
        cell = {
            "has_agent": as_bin(take(1)),
            "direction": np.argmax(take(4), axis=1).astype(np.int64),
        }
        if config.msg_bits > 0:
            cell["local_message"] = as_bin(take(config.msg_bits))
        cell["has_shelf"] = as_bin(take(1))
        cell["shelf_requested"] = as_bin(take(1))
        sensors.append(cell)
    obs["sensors"] = tuple(sensors)
    return obs


def convert_obs(config: WarehouseConfig, obs: Any) -> Tuple:
    """One env's host obs (N, ...) -> the reference's tuple over agents."""
    n, ot = config.n_agents, config.observation_type
    if ot in (ObservationType.FLATTENED, ObservationType.IMAGE):
        arr = np.asarray(obs, dtype=np.float32)
        return tuple(arr[i] for i in range(n))
    if ot == ObservationType.DICT:
        arr = np.asarray(obs, dtype=np.float32)
        return tuple(flat_to_dict(config, arr[i]) for i in range(n))
    img = np.asarray(obs["image"], dtype=np.float32)
    feat = np.asarray(obs["features"], dtype=np.float32)
    return tuple({"image": img[i], "features": feat[i]} for i in range(n))


def convert_obs_batch(config: WarehouseConfig, obs: Any) -> Tuple:
    """A batch's host obs (B, N, ...) -> a tuple over agents of batched
    leaves, the layout of ``gymnasium.vector.utils.batch_space``."""
    n, ot = config.n_agents, config.observation_type
    if ot in (ObservationType.FLATTENED, ObservationType.IMAGE):
        arr = np.asarray(obs, dtype=np.float32)
        return tuple(arr[:, i] for i in range(n))
    if ot == ObservationType.DICT:
        arr = np.asarray(obs, dtype=np.float32)
        return tuple(flat_to_dict_batch(config, arr[:, i]) for i in range(n))
    img = np.asarray(obs["image"], dtype=np.float32)
    feat = np.asarray(obs["features"], dtype=np.float32)
    return tuple({"image": img[:, i], "features": feat[:, i]} for i in range(n))


# -- numpy in, numpy out: what the Gymnasium classes run ----------------------------


def _obs_to_host(obs: Any, env: Optional[int] = None) -> Any:
    """Device obs (of env ``env``, or the whole batch) as numpy, in one copy."""
    if isinstance(obs, dict):
        leaves = [v if env is None else v[env] for v in obs.values()]
        return dict(zip(obs, to_host(*leaves)))
    return to_host(obs if env is None else obs[env])[0]


class HostEnv:
    """One env (a batch of one) on ``env.device`` with numpy actions in and
    the reference's outputs back: the device program of
    ``rware_tpu_torch.gym_adapter.GymWarehouse``.  ``reset(seed)`` seeds a
    ``torch.Generator`` on the device that draws the reset and every queue
    resample; a step is one host-to-device copy of the actions and one
    device-to-host copy of its outputs."""

    def __init__(self, env):
        self.env = env
        self.state: Optional[WarehouseState] = None
        self.generator: Optional[torch.Generator] = None

    def reset(self, seed: int) -> Tuple:
        """``(obs, {})`` of a fresh reset drawn from a generator seeded ``seed``."""
        self.generator = torch.Generator(device=self.env.device).manual_seed(int(seed))
        self.state, obs = self.env.reset(self.generator, 1)
        return convert_obs(self.env.config, _obs_to_host(obs, 0)), {}

    def actions_to_device(self, actions) -> torch.Tensor:
        """Per-agent actions (ints, or ``1 + msg_bits`` arrays) as (1, N[, 1 + M])."""
        if self.env.config.msg_bits > 0:
            acts = np.stack([np.asarray(a, dtype=np.int32) for a in actions])
        else:
            acts = np.asarray(actions, dtype=np.int32)
        return torch.from_numpy(acts[None]).to(self.env.device)

    def step(self, actions) -> Tuple:
        """``(obs, rewards, done, truncated, info)`` as the reference's
        ``step`` gives them."""
        res = self.env.step(self.state, self.actions_to_device(actions), self.generator)
        self.state = res.state
        obs, rewards, done, truncated, info = step_to_host(
            res.obs, res.rewards, res.done, res.truncated, res.info)
        obs = {k: v[0] for k, v in obs.items()} if isinstance(obs, dict) else obs[0]
        return (
            convert_obs(self.env.config, obs),
            [float(r) for r in rewards[0]],
            bool(done[0]),
            bool(truncated[0]),
            {k: np.asarray(v[0]) for k, v in info.items()},
        )


class HostVectorEnv:
    """``num_envs`` envs on ``env.device`` stepped with Gymnasium's NEXT_STEP
    autoreset (``Warehouse.step_next_autoreset``), numpy in and out: the
    device program of ``rware_tpu_torch.vector.VectorGymWarehouse``.  A
    step is one host-to-device copy of the actions and one device-to-host
    copy of its outputs."""

    def __init__(self, env, num_envs: int):
        self.env, self.num_envs = env, int(num_envs)
        self.states: Optional[WarehouseState] = None
        self.prev_done: Optional[torch.Tensor] = None
        self.generator: Optional[torch.Generator] = None

    def reset(self, seed) -> Tuple:
        """``(obs, {})``.  An int seeds one generator for the batch; a list of
        ints seeds env i from a generator of its own
        (``Warehouse.reset_from_seeds``), and the batch's step generator from
        all of them."""
        dev = self.env.device
        if isinstance(seed, (list, tuple)):
            if len(seed) != self.num_envs:
                raise ValueError(f"seed list length {len(seed)} != num_envs {self.num_envs}")
            self.states = self.env.reset_from_seeds(seed)
            batch_seed = np.random.SeedSequence([int(s) % 2**32 for s in seed])
            self.generator = torch.Generator(device=dev).manual_seed(
                int(batch_seed.generate_state(1)[0]))
        else:
            self.generator = torch.Generator(device=dev).manual_seed(int(seed))
            self.states = self.env.reset_state(self.generator, self.num_envs)
        self.prev_done = torch.zeros(self.num_envs, dtype=torch.bool, device=dev)
        return convert_obs_batch(self.env.config, _obs_to_host(self.env.observe(self.states))), {}

    def actions_to_device(self, actions: Any) -> torch.Tensor:
        """A tuple over agents of ``(B,)`` / ``(B, 1 + M)`` arrays, or a ready
        ``(B, N[, 1 + M])`` array, as int32 on the device."""
        n = self.env.config.n_agents
        if isinstance(actions, (tuple, list)) and len(actions) == n:
            acts = np.stack([np.asarray(a, dtype=np.int32) for a in actions], axis=1)
        else:
            acts = np.asarray(actions, dtype=np.int32)
        if self.env.config.msg_bits > 0 and acts.ndim == 2:
            raise ValueError("msg_bits > 0 actions need a trailing (1 + msg_bits) axis")
        return torch.from_numpy(acts).to(self.env.device)

    def step(self, actions) -> Tuple:
        """``(obs, rewards (B, N) float32, terminated (B,), truncated (B,),
        info)``."""
        res = self.env.step_next_autoreset(
            self.states, self.prev_done, self.actions_to_device(actions), self.generator)
        self.states, self.prev_done = res.state, res.done
        obs, rewards, done, truncated, info = step_to_host(
            res.obs, res.rewards, res.done, res.truncated, res.info)
        return convert_obs_batch(self.env.config, obs), rewards, done, truncated, info
