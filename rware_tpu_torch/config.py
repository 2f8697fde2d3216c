"""Frozen, hashable environment configuration.

A copy of ``rware_tpu/config.py``: importing the JAX package's module would
run ``rware_tpu/__init__.py``, which imports jax.  Mirrors all 15
constructor parameters of the reference ``Warehouse``
(rware/warehouse.py:146-233) as a frozen dataclass.  The config is hashable
(layouts are kept in their source form — parameters or DSL string);
derived geometry is compiled on demand via
:meth:`WarehouseConfig.compile_layout`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

from rware_tpu_torch.layout import Layout, make_layout_from_params, make_layout_from_str
from rware_tpu_torch.types import (
    DEFAULT_IMAGE_LAYERS,
    ImageLayer,
    ObservationType,
    RewardType,
)


@dataclasses.dataclass(frozen=True)
class WarehouseConfig:
    """Static configuration of one warehouse environment.

    Field names and defaults track the reference constructor
    (rware/warehouse.py:146-170); ``layout`` is the optional DSL string that
    overrides the parametric geometry (rware/warehouse.py:237-240).
    """

    shelf_columns: int = 3
    column_height: int = 8
    shelf_rows: int = 1
    n_agents: int = 2
    msg_bits: int = 0
    sensor_range: int = 1
    request_queue_size: int = 2
    max_inactivity_steps: Optional[int] = None
    max_steps: Optional[int] = 500
    reward_type: RewardType = RewardType.INDIVIDUAL
    layout: Optional[str] = None
    observation_type: ObservationType = ObservationType.FLATTENED
    image_observation_layers: Tuple[ImageLayer, ...] = DEFAULT_IMAGE_LAYERS
    image_observation_directional: bool = True
    normalised_coordinates: bool = False
    render_mode: str = "human"

    def __post_init__(self):
        if self.n_agents < 1:
            raise ValueError("n_agents must be >= 1")
        if self.request_queue_size < 0:
            # 0 is legal (the reference registers e.g. rware-tiny-1ag-hard-v2
            # with int(1 * 0.5) == 0 requests): no shelf is ever requested.
            raise ValueError("request_queue_size must be >= 0")
        # Normalise enum-likes and tuples so configs hash/compare consistently.
        object.__setattr__(self, "reward_type", RewardType(self.reward_type))
        object.__setattr__(
            self, "observation_type", ObservationType(self.observation_type)
        )
        object.__setattr__(
            self,
            "image_observation_layers",
            tuple(ImageLayer(l) for l in self.image_observation_layers),
        )
        if self.request_queue_size > self.compile_layout().n_shelves:
            raise ValueError("request_queue_size exceeds number of shelves")

    # -- derived static geometry ------------------------------------------------

    @functools.lru_cache(maxsize=None)
    def compile_layout(self) -> Layout:
        if self.layout is not None:
            return make_layout_from_str(self.layout)
        return make_layout_from_params(
            self.shelf_columns, self.shelf_rows, self.column_height
        )

    @property
    def grid_size(self) -> Tuple[int, int]:
        return self.compile_layout().grid_size

    @property
    def n_shelves(self) -> int:
        return self.compile_layout().n_shelves

    @property
    def n_goals(self) -> int:
        return self.compile_layout().n_goals

    # -- derived observation geometry (reference: rware/warehouse.py:429-443) ---

    @property
    def window_size(self) -> int:
        return 1 + 2 * self.sensor_range

    @property
    def n_sensor_cells(self) -> int:
        return self.window_size**2

    @property
    def obs_bits_for_self(self) -> int:
        return 4 + 4  # x, y, carrying, on_highway + direction one-hot

    @property
    def obs_bits_per_agent(self) -> int:
        return 1 + 4 + self.msg_bits  # has_agent + dir one-hot + message

    @property
    def obs_bits_per_shelf(self) -> int:
        return 2  # has_shelf + shelf_requested

    @property
    def flattened_obs_length(self) -> int:
        """Length of one agent's FLATTENED vector (= 71 for tiny defaults)."""
        return self.obs_bits_for_self + self.n_sensor_cells * (
            self.obs_bits_per_agent + self.obs_bits_per_shelf
        )

    @property
    def policy_obs_length(self) -> int:
        """Per-agent policy input width: the FLATTENED vector length, the
        flattened (C, w2, w2) image stack for IMAGE configs, or the image
        stack + the 6 self features [dir-onehot(4), on_highway, carrying]
        for IMAGE_DICT (the learner stack feeds MLPs a flat vector either
        way; reference rware/warehouse.py:725-742)."""
        if self.observation_type == ObservationType.IMAGE:
            return len(self.image_observation_layers) * self.n_sensor_cells
        if self.observation_type == ObservationType.IMAGE_DICT:
            return (
                len(self.image_observation_layers) * self.n_sensor_cells + 6
            )
        return self.flattened_obs_length
