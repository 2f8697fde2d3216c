"""Batched collision resolver (the counterpart of ``rware_tpu/ops/resolver.py``).

The same functional-graph formulation as the JAX resolver, written out over
a leading env axis B: every occupied cell has out-degree one (the move its
agent requests), so each weakly-connected component holds exactly one
terminus — a cycle or an empty sink cell.  Rules (reference
rware/warehouse.py:821-876):

  * agents whose action keeps them in place are self-loops and commit;
  * a component holding a head-on swap (2-cycle) commits nobody;
  * a component holding any other cycle commits exactly its cycle agents;
  * an acyclic component commits the longest chain into its sink, equal
    depths broken toward the lowest agent index.

The CUDA kernels carry a per-env loop form of the same rules
(``csrc/env_core.cuh``); this version is their plain reference.
"""
from __future__ import annotations

import torch


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-env gather tolerating -1 indices (clipped; caller masks)."""
    return torch.gather(arr, 1, idx.clamp(min=0).to(torch.int64))


def resolve_moves(
    start_x: torch.Tensor,
    start_y: torch.Tensor,
    target_x: torch.Tensor,
    target_y: torch.Tensor,
) -> torch.Tensor:
    """Decide which agents' requested moves commit.

    Args:
      start_x, start_y: (B, N) int32 current agent cells (distinct per env).
      target_x, target_y: (B, N) int32 requested cells; equal to the start
        for any agent not attempting a translation.

    Returns:
      (B, N) bool — True for agents whose request commits.
    """
    b, n = start_x.shape
    dev = start_x.device
    idx = torch.arange(n, device=dev)

    # match[b, i, j]: agent i's target is agent j's current cell.
    match = (target_x[:, :, None] == start_x[:, None, :]) & (
        target_y[:, :, None] == start_y[:, None, :]
    )
    has_next = match.any(dim=2)
    nxt = torch.where(has_next, match.to(torch.int32).argmax(dim=2), -1)

    # Cycle membership: follow successor pointers N steps.
    cur = nxt
    on_cycle = torch.zeros_like(has_next)
    for _ in range(n):
        on_cycle = on_cycle | (cur == idx)
        cur = torch.where(cur >= 0, _take(nxt, cur), -1)

    two_cycle = has_next & (nxt != idx) & (_take(nxt, nxt) == idx)

    # Weak-component closure: adjacent iff the edges share a cell.
    shared = (target_x[:, :, None] == target_x[:, None, :]) & (
        target_y[:, :, None] == target_y[:, None, :]
    )
    adj = shared | match | match.transpose(1, 2) | torch.eye(
        n, dtype=torch.bool, device=dev
    )
    for _ in range(max(1, (n - 1).bit_length())):
        a = adj.to(torch.float32)
        adj = adj | (torch.bmm(a, a) > 0)

    comp_poisoned = (adj & two_cycle[:, None, :]).any(dim=2)
    comp_has_cycle = (adj & on_cycle[:, None, :]).any(dim=2)
    committed_cycle = on_cycle & ~comp_poisoned

    # Chain rule: depth[i] = longest chain of agents ending at i.
    pred = match.transpose(1, 2)  # pred[b, i, j] = (nxt[b, j] == i)
    depth = torch.ones((b, n), dtype=torch.int32, device=dev)
    for _ in range(n):
        depth = 1 + torch.where(pred, depth[:, None, :], 0).amax(dim=2)

    di, dj = depth[:, :, None], depth[:, None, :]
    beats = (dj < di) | ((dj == di) & (idx[None, None, :] >= idx[None, :, None]))
    chosen = (~shared | beats).all(dim=2)

    committed_chain = chosen & ~has_next
    for _ in range(n):
        follow_ok = torch.where(has_next, _take(committed_chain, nxt), True)
        committed_chain = chosen & follow_ok
    committed_chain = committed_chain & ~comp_has_cycle

    return committed_cycle | committed_chain
