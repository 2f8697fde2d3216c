"""Public enums and constants of the warehouse (a copy of ``rware_tpu/types.py``).

These mirror the reference API surface (rware/warehouse.py:31-70)
so that user code written against the reference can switch over without edits.
Values are part of the wire format (actions are integer-coded on device), so the
integer assignments are fixed.
"""
from __future__ import annotations

import enum


class Action(enum.IntEnum):
    """Discrete per-agent actions (reference: rware/warehouse.py:31-36)."""

    NOOP = 0
    FORWARD = 1
    LEFT = 2
    RIGHT = 3
    TOGGLE_LOAD = 4


class Direction(enum.IntEnum):
    """Agent headings (reference: rware/warehouse.py:39-43).

    Note the enum values are NOT in rotation order; rotation order is
    UP -> RIGHT -> DOWN -> LEFT (see ``ROT_RIGHT``/``ROT_LEFT`` in core.engine).
    """

    UP = 0
    DOWN = 1
    LEFT = 2
    RIGHT = 3


class RewardType(enum.IntEnum):
    """Reward schemes (reference: rware/warehouse.py:46-49)."""

    GLOBAL = 0
    INDIVIDUAL = 1
    TWO_STAGE = 2


class ObservationType(enum.IntEnum):
    """Observation families (reference: rware/warehouse.py:52-56)."""

    DICT = 0
    FLATTENED = 1
    IMAGE = 2
    IMAGE_DICT = 3


class ImageLayer(enum.IntEnum):
    """Channels of image-style observations (reference: rware/warehouse.py:59-70)."""

    SHELVES = 0  # binary: cell holds a shelf (carried shelves included)
    REQUESTS = 1  # binary: cell holds a *requested* shelf
    AGENTS = 2  # binary: cell holds an agent
    AGENT_DIRECTION = 3  # int: Direction.value + 1 of the agent at the cell, else 0
    AGENT_LOAD = 4  # binary: cell holds a loaded agent
    GOALS = 5  # binary: cell is a goal
    ACCESSIBLE = 6  # binary: cell holds no agent


#: Default layer stack for image observations (reference: rware/warehouse.py:160-166).
DEFAULT_IMAGE_LAYERS = (
    ImageLayer.SHELVES,
    ImageLayer.REQUESTS,
    ImageLayer.AGENTS,
    ImageLayer.GOALS,
    ImageLayer.ACCESSIBLE,
)

#: Default layer stack for the global-image API (reference: rware/warehouse.py:966-973).
DEFAULT_GLOBAL_IMAGE_LAYERS = (ImageLayer.SHELVES, ImageLayer.GOALS)
