"""Observations (the counterpart of ``rware_tpu/core/observations.py``):
FLATTENED vectors, the global layer stack and the image windows.

FLATTENED bit layout (must match the reference exactly, incl. quirks —
rware/warehouse.py:631-674):
  self:  [x, y, carrying, dir-onehot(4), on_highway]
  per window cell (row-major, y-outer):
         [has_agent, dir-onehot(4) — empty cells write [1,0,0,0],
          message (msg_bits) of the agent there — 0 on empty cells,
          has_shelf, shelf_requested]
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.core.state import WarehouseState
from rware_tpu_torch.types import ImageLayer


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


def build_global_layers_fn(
    config: WarehouseConfig, layers: Tuple[ImageLayer, ...]
) -> Callable[[WarehouseState], torch.Tensor]:
    """Returns ``fn(state) -> (B, C, H, W) float32``, the global layer stack.

    The layer semantics of rware/warehouse.py:527-575 / 984-1019 with the
    reference's ``layer[ag.x, ag.y]`` transposition fixed: every layer is
    indexed ``[y, x]``.  SHELVES includes carried shelves; AGENT_DIRECTION
    holds ``dir + 1``; ACCESSIBLE is 1 on every cell without an agent.
    """
    layout = config.compile_layout()
    height, width = layout.grid_size
    goals_np = np.asarray(layout.goals, dtype=np.int64)

    def global_layers(state: WarehouseState) -> torch.Tensor:
        dev = state.device
        b = state.batch_size
        rows = torch.arange(b, device=dev)[:, None]
        ax, ay = state.agent_x.long(), state.agent_y.long()
        sx, sy = state.shelf_x.long(), state.shelf_y.long()

        def scatter(y, x, values, fill=0.0):
            layer = torch.full((b, height, width), fill, dtype=torch.float32, device=dev)
            layer[rows.expand_as(y), y, x] = values
            return layer

        out = []
        for layer_type in layers:
            if layer_type == ImageLayer.SHELVES:
                layer = scatter(sy, sx, 1.0)
            elif layer_type == ImageLayer.REQUESTS:
                q = state.request_queue.long()
                layer = scatter(torch.gather(sy, 1, q), torch.gather(sx, 1, q), 1.0)
            elif layer_type == ImageLayer.AGENTS:
                layer = scatter(ay, ax, 1.0)
            elif layer_type == ImageLayer.AGENT_DIRECTION:
                layer = scatter(ay, ax, (state.agent_dir + 1).to(torch.float32))
            elif layer_type == ImageLayer.AGENT_LOAD:
                layer = scatter(ay, ax, (state.agent_carrying >= 0).to(torch.float32))
            elif layer_type == ImageLayer.GOALS:
                goals = torch.as_tensor(goals_np, device=dev)
                layer = torch.zeros((b, height, width), dtype=torch.float32, device=dev)
                layer[:, goals[:, 1], goals[:, 0]] = 1.0
            elif layer_type == ImageLayer.ACCESSIBLE:
                layer = scatter(ay, ax, 0.0, fill=1.0)
            else:
                raise ValueError(f"Unknown image layer type: {layer_type}")
            out.append(layer)
        return torch.stack(out, dim=1)

    return global_layers


def build_image_obs_fn(
    config: WarehouseConfig,
) -> Callable[[WarehouseState], torch.Tensor]:
    """Returns ``obs(state) -> (B, N, C, w, w) float32`` windowed image obs.

    Reference: rware/warehouse.py:527-596.  The global layer stack is
    zero-padded by the sensor range (out-of-grid cells are 0 in every
    layer, ACCESSIBLE included), each agent's window is gathered and, unless
    the config is non-directional, rotated into the agent's frame with
    ``rot90`` over the window axes: k = 0 / 2 / 3 / 1 for UP / DOWN / LEFT /
    RIGHT.
    """
    r = config.sensor_range
    side = config.window_size
    global_layers = build_global_layers_fn(config, config.image_observation_layers)
    directional = config.image_observation_directional
    n_channels = len(config.image_observation_layers)

    def obs(state: WarehouseState) -> torch.Tensor:
        dev = state.device
        b, n = state.batch_size, state.n_agents
        padded = F.pad(global_layers(state), (r, r, r, r))  # (B, C, H + 2r, W + 2r)
        # the window of the agent at (x, y) starts at padded row y, column x
        offs = torch.arange(side, device=dev)
        rows = (state.agent_y.long()[..., None] + offs)[:, :, None, :, None]
        cols = (state.agent_x.long()[..., None] + offs)[:, :, None, None, :]
        env = torch.arange(b, device=dev)[:, None, None, None, None]
        chan = torch.arange(n_channels, device=dev)[None, None, :, None, None]
        win = padded[env, chan, rows, cols]  # (B, N, C, w, w)
        if not directional:
            return win
        turned = torch.stack([
            win,  # UP
            torch.rot90(win, 2, dims=(3, 4)),  # DOWN
            torch.rot90(win, 3, dims=(3, 4)),  # LEFT
            torch.rot90(win, 1, dims=(3, 4)),  # RIGHT
        ])
        pick = state.agent_dir.long()[None, :, :, None, None, None]
        return torch.gather(turned, 0, pick.expand((1,) + win.shape))[0]

    return obs


def build_image_dict_features_fn(
    config: WarehouseConfig,
) -> Callable[[WarehouseState], torch.Tensor]:
    """(B, N, 6) features of IMAGE_DICT observations: [dir-onehot(4),
    on_highway, carrying] (reference: rware/warehouse.py:725-742)."""
    highways_np = config.compile_layout().highways.astype(np.float32)

    def features(state: WarehouseState) -> torch.Tensor:
        highways = torch.as_tensor(highways_np, device=state.device)
        on_highway = highways[state.agent_y.long(), state.agent_x.long()]
        return torch.cat([
            F.one_hot(state.agent_dir.long(), 4).to(torch.float32),
            on_highway[..., None],
            (state.agent_carrying >= 0).to(torch.float32)[..., None],
        ], dim=-1)

    return features
