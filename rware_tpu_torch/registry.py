"""Environment-id naming scheme: parser and ``make``.

The same grammar as ``rware_tpu/registry.py`` (reference rware/__init__.py:22-175,
README.md:84-98), parsed on demand::

    rware[-img|-imgdict][-Nd][-<S>s]-<size|RxC>[-<H>h]-<N>ag[-<Q>req]
         [-easy|-hard|-indiv|-global|-twostage]-v2
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict

import torch

from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.types import ObservationType, RewardType

#: (shelf_rows, shelf_columns) per named size (rware/__init__.py:7-12).
SIZES: Dict[str, tuple] = {
    "tiny": (1, 3),
    "small": (2, 3),
    "medium": (2, 5),
    "large": (3, 5),
}

#: request_queue_size multiplier per difficulty (rware/__init__.py:14).
DIFFICULTY = {"easy": 2.0, "": 1.0, "hard": 0.5}

_ID_RE = re.compile(
    r"^rware"
    r"(?P<obs>-img|-imgdict)?"
    r"(?P<nd>-Nd)?"
    r"(?:-(?P<sensor>[2-5])s)?"
    r"-(?:(?P<size>tiny|small|medium|large)|(?P<rows>\d+)x(?P<cols>\d+))"
    r"(?:-(?P<height>\d+)h)?"
    r"-(?P<agents>\d+)ag"
    r"(?:-(?P<req>\d+)req)?"
    r"(?:-(?P<diff>easy|hard))?"
    r"(?:-(?P<rew>indiv|global|twostage))?"
    r"-v2$"
)

_REWARDS = {
    "indiv": RewardType.INDIVIDUAL,
    "global": RewardType.GLOBAL,
    "twostage": RewardType.TWO_STAGE,
}


def parse_env_id(env_id: str) -> WarehouseConfig:
    """Parse a reference-style env id into a :class:`WarehouseConfig`."""
    m = _ID_RE.match(env_id)
    if m is None:
        raise ValueError(f"Unrecognised env id: {env_id!r}")
    g = m.groupdict()

    if g["size"]:
        shelf_rows, shelf_columns = SIZES[g["size"]]
    else:
        shelf_rows, shelf_columns = int(g["rows"]), int(g["cols"])

    n_agents = int(g["agents"])
    if g["req"] is not None:
        request_queue_size = int(g["req"])
    else:
        request_queue_size = int(n_agents * DIFFICULTY[g["diff"] or ""])

    if g["obs"] == "-img":
        observation_type = ObservationType.IMAGE
    elif g["obs"] == "-imgdict":
        observation_type = ObservationType.IMAGE_DICT
    else:
        observation_type = ObservationType.FLATTENED
    if g["nd"] and g["obs"] is None:
        raise ValueError("-Nd (non-directional) applies only to image observations")

    return WarehouseConfig(
        shelf_columns=shelf_columns,
        column_height=int(g["height"]) if g["height"] else 8,
        shelf_rows=shelf_rows,
        n_agents=n_agents,
        msg_bits=0,
        sensor_range=int(g["sensor"]) if g["sensor"] else 1,
        request_queue_size=request_queue_size,
        max_inactivity_steps=None,
        max_steps=500,
        reward_type=_REWARDS[g["rew"]] if g["rew"] else RewardType.INDIVIDUAL,
        observation_type=observation_type,
        image_observation_directional=not g["nd"],
    )


def make(env_id_or_config, device="cpu", **overrides):
    """Create a :class:`~rware_tpu_torch.core.env.Warehouse` on ``device``.

    Accepts a reference-style env id string or a :class:`WarehouseConfig`;
    keyword overrides are applied on top of the parsed config.
    """
    from rware_tpu_torch.core.env import Warehouse

    if isinstance(env_id_or_config, str):
        config = parse_env_id(env_id_or_config)
    elif isinstance(env_id_or_config, WarehouseConfig):
        config = env_id_or_config
    else:
        raise TypeError(f"Expected env id or WarehouseConfig, got {env_id_or_config!r}")
    if overrides:
        config = dataclasses.replace(config, **overrides)
    return Warehouse(config, device=torch.device(device))
