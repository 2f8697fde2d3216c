"""Gymnasium-compatible adapter over the port's engine (the counterpart of
``rware_tpu/gym_adapter.py``).

A drop-in for the reference ``Warehouse(gym.Env)`` (rware/warehouse.py:140-292):
the same constructor surface, spaces, 5-tuple ``step`` contract,
``reset(seed)`` semantics, ``render`` and ``get_global_image``.  Inside it
runs :class:`rware_tpu_torch.core.host.HostEnv`: a batch of one
``WarehouseState`` on its device (the card unless the caller passes
``device="cpu"``) and a ``torch.Generator`` there for the draws; a step is one
device-to-host copy (obs, rewards, done, truncated and info packed together,
:func:`rware_tpu_torch.core.host.to_host`).

The adapter exists for API compatibility and interactive use.  Training code
should use the batched API (``rware_tpu_torch.make`` and the learners): the
Python-object boundary here caps throughput at host speed by design.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, List, Optional, Tuple

import gymnasium as gym
import numpy as np
import torch

from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.core.env import Warehouse
from rware_tpu_torch.core.host import HostEnv, convert_obs, to_host
from rware_tpu_torch.core.observations import build_global_layers_fn
from rware_tpu_torch.core.state import WarehouseState
from rware_tpu_torch.registry import SIZES, parse_env_id
from rware_tpu_torch.types import DEFAULT_GLOBAL_IMAGE_LAYERS, Action, ImageLayer, ObservationType

ENTRY_POINT = "rware_tpu_torch.gym_adapter:GymWarehouse"
VECTOR_ENTRY_POINT = "rware_tpu_torch.vector:vector_entry_point"


class GymWarehouse(gym.Env):
    """Stateful Gymnasium view of one warehouse on one device."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 10}

    #: positional parameter order of the reference constructor
    #: (rware/warehouse.py:146-170) for drop-in compatibility.
    _REF_PARAM_ORDER = (
        "shelf_columns",
        "column_height",
        "shelf_rows",
        "n_agents",
        "msg_bits",
        "sensor_range",
        "request_queue_size",
        "max_inactivity_steps",
        "max_steps",
        "reward_type",
        "layout",
        "observation_type",
        "image_observation_layers",
        "image_observation_directional",
        "normalised_coordinates",
        "render_mode",
    )

    def __init__(
        self,
        config: Optional[WarehouseConfig] = None,
        *args,
        env_id: Optional[str] = None,
        device="cuda",
        **kwargs,
    ):
        if isinstance(config, int):
            # reference-style positional construction:
            # Warehouse(shelf_columns, column_height, ..., reward_type, **kw)
            pos = (config,) + args
            if len(pos) > len(self._REF_PARAM_ORDER):
                raise TypeError(
                    f"Warehouse takes at most {len(self._REF_PARAM_ORDER)} "
                    f"positional arguments ({len(pos)} given)"
                )
            kwargs.update(zip(self._REF_PARAM_ORDER, pos))
            config = None
        elif args:
            raise TypeError("unexpected positional arguments")
        if config is None:
            # env_id is parsed here, not at registration, so that an id whose
            # config is invalid fails at construction; extra kwargs override
            # the id's config, as gym.make("rware-...-v2", max_steps=1000)
            # does upstream.
            if env_id:
                config = parse_env_id(env_id)
                if kwargs:
                    config = dataclasses.replace(config, **kwargs)
            else:
                config = WarehouseConfig(**kwargs)
        elif kwargs or env_id:
            raise TypeError("Pass either a config or kwargs, not both")
        self._env = Warehouse(config, device=device)
        self._host = HostEnv(self._env)
        self.device = self._env.device
        self.config = config
        self.render_mode = config.render_mode
        self.reward_range = (0, 1)
        self._renderer = None
        self._global_image_cache = None
        self._global_image_fns = {}

        self.action_space = self._build_action_space()
        self.observation_space = self._build_observation_space()

    # -- spaces (reference: rware/warehouse.py:255-288, 352-522) ---------------

    def _build_action_space(self) -> gym.spaces.Tuple:
        cfg = self.config
        if cfg.msg_bits == 0:
            sa = gym.spaces.Discrete(len(Action))
        else:
            sa = gym.spaces.MultiDiscrete([len(Action), *cfg.msg_bits * (2,)])
        return gym.spaces.Tuple(tuple(cfg.n_agents * [sa]))

    def _dict_obs_space(self) -> gym.spaces.Tuple:
        cfg = self.config
        max_grid_val = max(cfg.grid_size)
        if cfg.normalised_coordinates:
            high, dtype = np.ones(2), np.float32
        else:
            high, dtype = np.ones(2) * max_grid_val, np.int32
        location_space = gym.spaces.Box(np.zeros(2), high, shape=(2,), dtype=dtype)
        self_space = gym.spaces.Dict(
            OrderedDict(
                location=location_space,
                carrying_shelf=gym.spaces.MultiBinary(1),
                direction=gym.spaces.Discrete(4),
                on_highway=gym.spaces.MultiBinary(1),
            )
        )
        sensor = OrderedDict(
            has_agent=gym.spaces.MultiBinary(1),
            direction=gym.spaces.Discrete(4),
        )
        if cfg.msg_bits > 0:
            sensor["local_message"] = gym.spaces.MultiBinary(cfg.msg_bits)
        sensor["has_shelf"] = gym.spaces.MultiBinary(1)
        sensor["shelf_requested"] = gym.spaces.MultiBinary(1)
        per_agent = gym.spaces.Dict(
            OrderedDict(
                self=self_space,
                sensors=gym.spaces.Tuple(
                    cfg.n_sensor_cells * (gym.spaces.Dict(sensor),)
                ),
            )
        )
        return gym.spaces.Tuple(tuple(cfg.n_agents * [per_agent]))

    def _image_obs_space(self) -> gym.spaces.Tuple:
        cfg = self.config
        shape = (cfg.window_size, cfg.window_size)
        mins, maxs = [], []
        for layer in cfg.image_observation_layers:
            hi = 4.0 if layer == ImageLayer.AGENT_DIRECTION else 1.0
            mins.append(np.zeros(shape, dtype=np.float32))
            maxs.append(np.full(shape, hi, dtype=np.float32))
        box = gym.spaces.Box(np.stack(mins), np.stack(maxs), dtype=np.float32)
        return gym.spaces.Tuple(tuple(cfg.n_agents * [box]))

    def _build_observation_space(self) -> gym.spaces.Tuple:
        cfg = self.config
        ot = cfg.observation_type
        if ot == ObservationType.DICT:
            return self._dict_obs_space()
        if ot == ObservationType.FLATTENED:
            box = gym.spaces.Box(
                -np.inf, np.inf, shape=(cfg.flattened_obs_length,), dtype=np.float32
            )
            return gym.spaces.Tuple(tuple(cfg.n_agents * [box]))
        if ot == ObservationType.IMAGE:
            return self._image_obs_space()
        # IMAGE_DICT: {image, features(6,)} per agent (rware/warehouse.py:390-427)
        image_space = self._image_obs_space()[0]
        feature_space = gym.spaces.Box(-np.inf, np.inf, (6,), dtype=np.float32)
        per_agent = gym.spaces.Dict(
            {"image": image_space, "features": feature_space}
        )
        return gym.spaces.Tuple(tuple(cfg.n_agents * [per_agent]))

    # -- observation conversion ------------------------------------------------

    def _convert_obs(self, obs: Any) -> Tuple:
        """Host obs of one env, (N, ...) or a dict of such, -> the tuple
        over agents; device obs of a batch of one are brought over first."""
        if isinstance(obs, torch.Tensor):
            obs = to_host(obs[0])[0]
        elif isinstance(obs, dict) and isinstance(obs["image"], torch.Tensor):
            img, feat = to_host(obs["image"][0], obs["features"][0])
            obs = {"image": img, "features": feat}
        return convert_obs(self.config, obs)

    # -- gym API ---------------------------------------------------------------

    def seed(self, seed: Optional[int] = None):
        """Legacy seeding API (reference: rware/warehouse.py:962-964):
        stores the seed for the next reset."""
        self._pending_seed = seed
        return [seed]

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        pending = getattr(self, "_pending_seed", None)
        self._pending_seed = None  # a stored legacy seed applies exactly once
        if seed is None:
            seed = pending
        if seed is None:
            seed = int(self.np_random.integers(0, 2**31 - 1))
        self._global_image_cache = None
        return self._host.reset(seed)

    def step(self, actions):
        if self._host.state is None:
            raise RuntimeError("Call reset() before step()")
        out = self._host.step(actions)
        self._global_image_cache = None
        return out

    def render(self):
        from rware_tpu_torch.rendering import Viewer

        if self._renderer is None:
            self._renderer = Viewer(self.config)
        return self._renderer.render(
            self._host.state, return_rgb_array=self.render_mode == "rgb_array"
        )

    def close(self):
        if self._renderer is not None:
            self._renderer.close()
            self._renderer = None

    # -- reference-surface conveniences ---------------------------------------

    @property
    def state(self) -> WarehouseState:
        """The underlying device state, a batch of one (read or replace it
        for test injection)."""
        return self._host.state

    @state.setter
    def state(self, value: WarehouseState):
        self._host.state = value
        self._global_image_cache = None

    @property
    def n_agents(self) -> int:
        return self.config.n_agents

    @property
    def grid_size(self) -> Tuple[int, int]:
        return self.config.grid_size

    @property
    def request_queue(self) -> List[int]:
        return to_host(self._host.state.request_queue[0])[0].tolist()

    @property
    def goals(self) -> List[Tuple[int, int]]:
        return [tuple(g) for g in self._env.layout.goals.tolist()]

    @property
    def highways(self) -> np.ndarray:
        return self._env.layout.highways

    def get_global_image(
        self,
        image_layers=DEFAULT_GLOBAL_IMAGE_LAYERS,
        recompute: bool = False,
        pad_to_shape: Optional[Tuple[int, int]] = None,
    ) -> np.ndarray:
        """Global layer-stack view (reference: rware/warehouse.py:966-1040):
        cached until the state changes, optional centre-pad to a target shape."""
        if self._global_image_cache is None or recompute:
            # one layer function per layers-tuple, built on first use
            layers = tuple(image_layers)
            if layers not in self._global_image_fns:
                self._global_image_fns[layers] = build_global_layers_fn(self.config, layers)
            img = to_host(self._global_image_fns[layers](self._host.state)[0])[0]
            if pad_to_shape is not None:
                # Reference semantics (warehouse.py:1022-1039): zip the target
                # shape against leading axes of (C, H, W); before = floor,
                # after = ceil of the split.
                dims = [
                    target - cur
                    for target, cur in zip(pad_to_shape, img.shape)
                ]
                if any(d < 0 for d in dims):
                    raise ValueError("pad_to_shape smaller than global image")
                pad = [(d // 2, d - d // 2) for d in dims]
                pad += [(0, 0)] * (img.ndim - len(pad))
                img = np.pad(img, pad)
            self._global_image_cache = img
        return self._global_image_cache


def make_gym(env_id_or_config, device="cuda", **overrides) -> GymWarehouse:
    """Create a Gymnasium-style env from an id string or config, on
    ``device`` (the card unless the caller asks for another)."""
    if isinstance(env_id_or_config, str):
        config = parse_env_id(env_id_or_config)
    else:
        config = env_id_or_config
    if overrides:
        config = dataclasses.replace(config, **overrides)
    return GymWarehouse(config, device=device)


def _register(env_id: str, force: bool) -> bool:
    if env_id in gym.registry and not force:
        return False
    gym.register(
        id=env_id,
        entry_point=ENTRY_POINT,
        vector_entry_point=VECTOR_ENTRY_POINT,
        kwargs={"env_id": env_id},
    )
    return True


def register_all(force: bool = False, image: bool = False) -> int:
    """Register the reference's default env-id grid with gymnasium (4 sizes
    x 1-19 agents x 3 difficulties, rware/__init__.py:22-39; ``image=True``
    adds the -img/-imgdict/-Nd variants, rware/__init__.py:42-80).  Runs at
    ``import rware_tpu_torch`` by default; ids already registered (by the
    reference, or by ``rware_tpu``) are skipped unless ``force``.  Any other
    id of the naming grammar works unregistered through :func:`make_gym`.
    ``gym.make(id, device="cpu")`` passes the device on.  Returns the number
    of ids registered."""
    prefixes = ["rware"]
    if image:
        prefixes += ["rware-img", "rware-imgdict", "rware-img-Nd", "rware-imgdict-Nd"]
    return sum(
        _register(f"{prefix}-{size}-{n_agents}ag{diff}-v2", force)
        for prefix in prefixes
        for size in SIZES
        for n_agents in range(1, 20)
        for diff in ["", "-easy", "-hard"]
    )


def register_full(
    sensor_ranges=range(2, 6),
    column_heights=range(1, 16),
    force: bool = False,
) -> int:
    """Register the ``full_registration`` variants (rware/__init__.py:83-175):
    sensor-range ``-<S>s`` and column-height ``-<H>h`` grids over the default
    sizes, agents and difficulties; opt-in, as in ``rware_tpu``.  Returns
    the number of ids registered."""
    variants = [f"rware-{s}s" for s in sensor_ranges]
    heights = list(column_heights)
    count = 0
    for size in SIZES:
        for n_agents in range(1, 20):
            for diff in ["", "-easy", "-hard"]:
                ids = [f"{v}-{size}-{n_agents}ag{diff}-v2" for v in variants] + [
                    f"rware-{size}-{h}h-{n_agents}ag{diff}-v2" for h in heights
                ]
                count += sum(_register(env_id, force) for env_id in ids)
    return count
