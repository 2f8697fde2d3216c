"""FLATTENED observations (the counterpart of
``rware_tpu/core/observations.py::build_flattened_obs_fn``).

Bit layout (must match the reference exactly, incl. quirks —
rware/warehouse.py:631-674):
  self:  [x, y, carrying, dir-onehot(4), on_highway]
  per window cell (row-major, y-outer):
         [has_agent, dir-onehot(4) — empty cells write [1,0,0,0],
          message (msg_bits) of the agent there — 0 on empty cells,
          has_shelf, shelf_requested]
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.core.state import WarehouseState


def window_offsets(sensor_range: int) -> tuple[np.ndarray, np.ndarray]:
    """Row-major (dy, dx) offsets of the (2r+1)^2 window, y-outer."""
    r = sensor_range
    dy, dx = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1), indexing="ij")
    return dy.reshape(-1), dx.reshape(-1)


def build_flattened_obs_fn(
    config: WarehouseConfig,
) -> Callable[[WarehouseState], torch.Tensor]:
    """Returns ``obs(state) -> (B, N, L) float32``."""
    layout = config.compile_layout()
    height, width = layout.grid_size
    highways_np = layout.highways.astype(np.float32)
    dy_np, dx_np = window_offsets(config.sensor_range)
    normalised = config.normalised_coordinates
    msg_bits = config.msg_bits

    def obs(state: WarehouseState) -> torch.Tensor:
        dev = state.device
        dy = torch.as_tensor(dy_np, dtype=torch.int32, device=dev)
        dx = torch.as_tensor(dx_np, dtype=torch.int32, device=dev)
        highways = torch.as_tensor(highways_np, device=dev)
        ax, ay = state.agent_x, state.agent_y
        b, n = ax.shape
        # (B, N, W2) absolute coordinates of each agent's window cells.
        cx = ax[:, :, None] + dx
        cy = ay[:, :, None] + dy

        # Neighbouring agents: (B, N, W2, N) one-hot over agent index.
        agent_match = (cx[..., None] == ax[:, None, None, :]) & (
            cy[..., None] == ay[:, None, None, :]
        )
        has_agent = agent_match.any(dim=-1)
        # Empty cells give direction 0 == UP: the reference's empty-cell
        # one-hot [1,0,0,0] (rware/warehouse.py:658-659).
        cell_dir = (agent_match * state.agent_dir[:, None, None, :]).sum(dim=-1)
        dir_onehot = F.one_hot(cell_dir.to(torch.int64), 4).to(torch.float32)
        cell_feats = [has_agent[..., None].to(torch.float32), dir_onehot]
        if msg_bits:
            # the message of the agent on the cell (at most one agent per cell)
            cell_feats.append((agent_match[..., None] * state.agent_message[:, None, None])
                              .sum(dim=3, dtype=torch.float32))

        # Neighbouring shelves: (B, N, W2, S).
        shelf_match = (cx[..., None] == state.shelf_x[:, None, None, :]) & (
            cy[..., None] == state.shelf_y[:, None, None, :]
        )
        has_shelf = shelf_match.any(dim=-1)
        requested = (shelf_match & state.in_queue_mask()[:, None, None, :]).any(dim=-1)

        per_cell = torch.cat(
            cell_feats + [has_shelf[..., None].to(torch.float32),
                          requested[..., None].to(torch.float32)],
            dim=-1,
        )  # (B, N, W2, 7 + msg_bits)
        sensor_part = per_cell.reshape(b, n, -1)

        fx = ax.to(torch.float32)
        fy = ay.to(torch.float32)
        if normalised:
            # Divide by a tensor: CUDA torch turns division by a Python
            # scalar into a multiply by its reciprocal, which rounds
            # differently from the true division of JAX and the kernels.
            fx = fx / torch.full_like(fx, width - 1)
            fy = fy / torch.full_like(fy, height - 1)
        self_part = torch.cat(
            [
                fx[..., None],
                fy[..., None],
                (state.agent_carrying >= 0).to(torch.float32)[..., None],
                F.one_hot(state.agent_dir.to(torch.int64), 4).to(torch.float32),
                highways[ay.to(torch.int64), ax.to(torch.int64)][..., None],
            ],
            dim=-1,
        )
        return torch.cat([self_part, sensor_part], dim=-1)

    return obs
