"""The environment state: one dataclass of batched tensors.

The counterpart of ``rware_tpu/core/state.py``.  Every field carries a
leading env axis ``B``; there is no per-env PRNG key: randomness is an
explicit argument of the functions that need it (a ``torch.Generator`` or
the counter-based stream of :mod:`rware_tpu_torch.ops.philox`).

Index conventions (as in the JAX package):
  * agents and shelves are 0-indexed.
  * ``agent_carrying`` holds the 0-based shelf index being carried, or -1.
  * ``request_queue`` holds 0-based shelf indices; slot order is
    meaningful (deliveries replace the slot in place,
    rware/warehouse.py:917).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class WarehouseState:
    """Complete dynamic state of a batch of B warehouse environments."""

    agent_x: torch.Tensor  # (B, N) int32
    agent_y: torch.Tensor  # (B, N) int32
    agent_dir: torch.Tensor  # (B, N) int32, Direction values
    agent_carrying: torch.Tensor  # (B, N) int32, shelf index or -1
    agent_has_delivered: torch.Tensor  # (B, N) bool
    agent_message: torch.Tensor  # (B, N, msg_bits) float32
    shelf_x: torch.Tensor  # (B, S) int32
    shelf_y: torch.Tensor  # (B, S) int32
    request_queue: torch.Tensor  # (B, R) int32, shelf indices
    cur_steps: torch.Tensor  # (B,) int32
    cur_inactive_steps: torch.Tensor  # (B,) int32

    # -- derived views ---------------------------------------------------------

    @property
    def batch_size(self) -> int:
        return self.agent_x.shape[0]

    @property
    def n_agents(self) -> int:
        return self.agent_x.shape[1]

    @property
    def n_shelves(self) -> int:
        return self.shelf_x.shape[1]

    @property
    def device(self) -> torch.device:
        return self.agent_x.device

    def replace(self, **fields) -> "WarehouseState":
        return dataclasses.replace(self, **fields)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "WarehouseState":
        """Apply ``fn`` to every field."""
        return WarehouseState(
            **{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)}
        )

    def where(self, mask: torch.Tensor, other: "WarehouseState") -> "WarehouseState":
        """Per env: ``self`` where ``mask`` (B,) is True, else ``other``."""
        out = {}
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
            out[f.name] = torch.where(m, a, b)
        return WarehouseState(**out)

    def in_queue_mask(self) -> torch.Tensor:
        """(B, S) bool: which shelves are currently requested."""
        s = torch.arange(self.n_shelves, dtype=torch.int32, device=self.device)
        return (self.request_queue[:, :, None] == s).any(dim=1)

    # -- test injection (every env of the batch is changed) ----------------------

    def set_agent(self, i, *, x=None, y=None, direction=None, carrying=None,
                  has_delivered=None) -> "WarehouseState":
        """Return a state with agent ``i`` teleported/modified."""
        updates = {
            "agent_x": x,
            "agent_y": y,
            "agent_dir": None if direction is None else int(direction),
            "agent_carrying": carrying,
            "agent_has_delivered": has_delivered,
        }
        out = self
        for name, value in updates.items():
            if value is not None:
                t = getattr(out, name).clone()
                t[:, i] = value
                out = out.replace(**{name: t})
        return out


def state_field_names() -> tuple:
    return tuple(f.name for f in dataclasses.fields(WarehouseState))
