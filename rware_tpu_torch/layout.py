"""Layout compiler: warehouse geometry as constants (a copy of
``rware_tpu/layout.py``).

The reference builds its geometry imperatively inside ``Warehouse.__init__``
(rware/warehouse.py:294-350).  Here geometry is compiled once into immutable
numpy arrays that the engine and the kernels take as constants.  Everything
that depends only on the layout (highway mask, goal list, shelf home slots)
is precomputed so the device programs contain no data-dependent shapes.

Grid conventions (same as reference): ``grid_size = (H, W)``; cells are
addressed ``[y, x]``; goals are stored as ``(x, y)`` pairs.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Layout:
    """Static, hashable-by-identity geometry of a warehouse.

    Attributes:
      grid_size: (H, W).
      highways: uint8 (H, W) mask; 1 = corridor/goal cell, 0 = shelf rack slot.
      goals: int32 (G, 2) array of (x, y) goal cells, in registration order.
      shelf_slots: int32 (S, 2) array of (x, y) rack cells in row-major order.
        These are the reset positions of shelves; shelf ``s`` (0-based) spawns
        at ``shelf_slots[s]``, matching the reference's row-major 1-based shelf
        ids (rware/warehouse.py:771-778).
      column_height: the column height used for parametric layouts (0 for
        string layouts; only used by renderers/metadata).
    """

    grid_size: Tuple[int, int]
    highways: np.ndarray
    goals: np.ndarray
    shelf_slots: np.ndarray
    column_height: int = 0

    @property
    def height(self) -> int:
        return self.grid_size[0]

    @property
    def width(self) -> int:
        return self.grid_size[1]

    @property
    def n_goals(self) -> int:
        return int(self.goals.shape[0])

    @property
    def n_shelves(self) -> int:
        return int(self.shelf_slots.shape[0])


def _shelf_slots_from_highways(highways: np.ndarray) -> np.ndarray:
    """Row-major (x, y) coordinates of all non-highway cells."""
    ys, xs = np.nonzero(highways == 0)
    # np.nonzero on a 2-D array already yields row-major (y-outer) order,
    # matching the reference's shelf id assignment (rware/warehouse.py:771-778).
    return np.stack([xs, ys], axis=1).astype(np.int32)


def make_layout_from_params(
    shelf_columns: int, shelf_rows: int, column_height: int
) -> Layout:
    """Parametric layout (reference: rware/warehouse.py:294-326).

    H = (column_height + 1) * shelf_rows + 2, W = 3 * shelf_columns + 1.
    Highways are the vertical corridors (x % 3 == 0), horizontal corridors
    (y % (column_height+1) == 0), the delivery row (y == H-1) and the 2-wide
    goal queue column near the bottom.  Two goals sit bottom-middle.
    """
    if shelf_columns % 2 != 1:
        raise ValueError("Only an odd number of shelf columns is supported")

    height = (column_height + 1) * shelf_rows + 2
    width = 3 * shelf_columns + 1
    goals = np.array(
        [[width // 2 - 1, height - 1], [width // 2, height - 1]], dtype=np.int32
    )

    ys = np.arange(height)[:, None]
    xs = np.arange(width)[None, :]
    vertical = (xs % 3) == 0
    horizontal = (ys % (column_height + 1)) == 0
    delivery_row = ys == height - 1
    queue = (ys > height - (column_height + 3)) & (
        (xs == width // 2 - 1) | (xs == width // 2)
    )
    highways = (vertical | horizontal | delivery_row | queue).astype(np.uint8)

    return Layout(
        grid_size=(height, width),
        highways=highways,
        goals=goals,
        shelf_slots=_shelf_slots_from_highways(highways),
        column_height=column_height,
    )


def make_layout_from_str(layout: str) -> Layout:
    """String-DSL layout (reference: rware/warehouse.py:328-350).

    ``.`` = highway, ``x`` = shelf rack slot, ``g`` = goal (also a highway).
    The layout must be rectangular and contain at least one goal.
    """
    layout = layout.strip().replace(" ", "")
    lines = layout.split("\n")
    height = len(lines)
    width = len(lines[0])
    for line in lines:
        if len(line) != width:
            raise ValueError("Layout must be rectangular")

    highways = np.zeros((height, width), dtype=np.uint8)
    goals = []
    for y, line in enumerate(lines):
        for x, char in enumerate(line):
            c = char.lower()
            if c not in "gx.":
                raise ValueError(f"Invalid layout character {char!r}")
            if c == "g":
                goals.append((x, y))
                highways[y, x] = 1
            elif c == ".":
                highways[y, x] = 1

    if not goals:
        raise ValueError("At least one goal is required")

    return Layout(
        grid_size=(height, width),
        highways=highways,
        goals=np.asarray(goals, dtype=np.int32),
        shelf_slots=_shelf_slots_from_highways(highways),
        column_height=0,
    )
