"""State-injection helpers (the counterpart of ``rware_tpu/testing.py``).

:func:`make_state` builds an exact one-env state (B = 1) for a test scenario,
with shelves at their home slots unless overridden — the functional form of
the reference's "mutate agents and shelves, then ``_recalc_grid()``" test
pattern (reference tests/test_movement.py:14-61).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.core.state import WarehouseState
from rware_tpu_torch.types import Direction


def make_state(
    config: WarehouseConfig,
    agents: Sequence[Tuple],
    *,
    shelves: Optional[Sequence[Tuple[int, int]]] = None,
    queue: Optional[Sequence[int]] = None,
    carrying: Optional[Sequence[int]] = None,
    has_delivered: Optional[Sequence[bool]] = None,
    device="cpu",
) -> WarehouseState:
    """Build a one-env WarehouseState for a test scenario.

    Args:
      config: static env config (must match the lengths given here).
      agents: per-agent ``(x, y, direction)`` tuples.
      shelves: optional per-shelf ``(x, y)``; defaults to home rack slots.
      queue: optional request-queue shelf indices (0-based); defaults to
        ``[0, 1, ..., R-1]``.
      carrying: optional per-agent carried shelf index or -1.
      has_delivered: optional per-agent TWO_STAGE delivery flags.
      device: where the state's tensors live.
    """
    layout = config.compile_layout()
    n = config.n_agents
    if len(agents) != n:
        raise ValueError(f"need {n} agent tuples, got {len(agents)}")

    def ints(values):
        return torch.tensor([list(values)], dtype=torch.int32, device=device)

    ax = ints(a[0] for a in agents)
    ay = ints(a[1] for a in agents)
    adir = ints(int(a[2]) for a in agents)
    if shelves is None:
        sx = ints(layout.shelf_slots[:, 0].tolist())
        sy = ints(layout.shelf_slots[:, 1].tolist())
    else:
        if len(shelves) != layout.n_shelves:
            raise ValueError(
                f"need {layout.n_shelves} shelf positions, got {len(shelves)}"
            )
        sx = ints(s[0] for s in shelves)
        sy = ints(s[1] for s in shelves)
    if queue is None:
        queue = range(config.request_queue_size)
    if carrying is None:
        carrying = [-1] * n
    if has_delivered is None:
        has_delivered = [False] * n

    # Carried shelves ride on their carrier (reference invariant).
    for i, c in enumerate(carrying):
        if c >= 0:
            sx[0, c] = ax[0, i]
            sy[0, c] = ay[0, i]

    zero = torch.zeros(1, dtype=torch.int32, device=device)
    return WarehouseState(
        agent_x=ax,
        agent_y=ay,
        agent_dir=adir,
        agent_carrying=ints(carrying),
        agent_has_delivered=torch.tensor(
            [list(has_delivered)], dtype=torch.bool, device=device
        ),
        agent_message=torch.zeros(
            (1, n, config.msg_bits), dtype=torch.float32, device=device
        ),
        shelf_x=sx,
        shelf_y=sy,
        request_queue=ints(queue).reshape(1, -1),
        cur_steps=zero.clone(),
        cur_inactive_steps=zero.clone(),
    )


UP = Direction.UP
DOWN = Direction.DOWN
LEFT = Direction.LEFT
RIGHT = Direction.RIGHT


def positions(state: WarehouseState, env: int = 0) -> list:
    """[(x, y), ...] per agent of one env — concise assertion helper."""
    return list(zip(state.agent_x[env].tolist(), state.agent_y[env].tolist()))
