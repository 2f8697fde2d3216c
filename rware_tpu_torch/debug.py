"""State invariants and debug checks (the counterpart of ``rware_tpu/debug.py``).

The engine keeps the physical invariants it assumes, but injected and test
states can break them.  The checks run on the state's device over the whole
batch and come to the host in one copy: :func:`state_invariant_errors` lists
the violated invariants of every env (the JAX package's messages, each with
its env index), :func:`validate_state` raises on any, and
:func:`checked_step` wraps a step function with the post-step checks of JAX's
checkify mode, surfaced by ``err.throw()``.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.core.host import to_host
from rware_tpu_torch.core.state import WarehouseState

#: the per-env checks of :func:`invariant_flags`, in the order of their
#: messages (``rware_tpu/debug.py:35-64``); the per-agent check of a carried
#: shelf's position comes between the last two
STATE_CHECKS = (
    "agent out of bounds",
    "shelf out of bounds",
    "two agents share a cell",
    "two shelves share a cell",
    "carrying index out of range",
    "one shelf carried by two agents",
    "request queue invalid (duplicate or out of range)",
)
#: the post-step checks of :func:`checked_step` (``rware_tpu/debug.py:83-99``)
STEP_CHECKS = ("two agents share a cell after step", "carried shelf not under its carrier")


def _has_duplicate(keys: torch.Tensor) -> torch.Tensor:
    """(B,) bool: some row of ``keys`` (B, K) holds a value twice."""
    if keys.shape[1] < 2:
        return torch.zeros(keys.shape[0], dtype=torch.bool, device=keys.device)
    return (keys.sort(dim=1).values.diff(dim=1) == 0).any(dim=1)


def _cells(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One int64 key per (x, y) pair of int32 coordinates, distinct for
    distinct pairs whatever their range."""
    return y.long() * 2**32 + x.long()


def _in_grid(x, y, h, w) -> torch.Tensor:
    return ((x >= 0) & (x < w) & (y >= 0) & (y < h)).all(dim=1)


def _misplaced_carried(state: WarehouseState, n_shelves: int) -> torch.Tensor:
    """(B, N) bool: agent i carries a shelf (in range) that is not on its cell."""
    c = state.agent_carrying.long()
    held = (c >= 0) & (c < n_shelves)
    idx = torch.where(held, c, 0)
    on = (torch.gather(state.shelf_x, 1, idx) == state.agent_x) & (
        torch.gather(state.shelf_y, 1, idx) == state.agent_y)
    return held & ~on


def invariant_flags(state: WarehouseState, config: WarehouseConfig):
    """On the state's device: ``(violated (B, len(STATE_CHECKS)) bool,
    misplaced (B, N) bool)``, the latter where agent i's carried shelf is
    not under it."""
    h, w = config.grid_size
    n_shelves = config.n_shelves
    n = state.n_agents
    c = state.agent_carrying
    q = state.request_queue
    held_keys = torch.where(c >= 0, c.long(),
                            -1 - torch.arange(n, device=c.device, dtype=torch.int64))
    queue_bad = _has_duplicate(q.long()) | ~((q >= 0) & (q < n_shelves)).all(dim=1)
    if q.shape[1] == 0:
        queue_bad = torch.zeros_like(queue_bad)
    violated = torch.stack([
        ~_in_grid(state.agent_x, state.agent_y, h, w),
        ~_in_grid(state.shelf_x, state.shelf_y, h, w),
        _has_duplicate(_cells(state.agent_x, state.agent_y)),
        _has_duplicate(_cells(state.shelf_x, state.shelf_y)),
        ~((c >= -1) & (c < n_shelves)).all(dim=1),
        _has_duplicate(held_keys),
        queue_bad,
    ], dim=1)
    return violated, _misplaced_carried(state, n_shelves)


def state_invariant_errors(state: WarehouseState, config: WarehouseConfig) -> List[str]:
    """Human-readable list of the violated invariants of every env of the
    batched state, ``"env b: <message>"``, in env order and in each env in
    the JAX package's order."""
    violated, misplaced = invariant_flags(state, config)
    violated, misplaced, carrying = to_host(violated, misplaced, state.agent_carrying)
    errs = []
    for b in np.flatnonzero(violated.any(axis=1) | misplaced.any(axis=1)):
        msgs = [m for m, bad in zip(STATE_CHECKS[:-1], violated[b]) if bad]
        msgs += [f"carried shelf {carrying[b, i]} not under its carrier {i}"
                 for i in np.flatnonzero(misplaced[b])]
        if violated[b, -1]:
            msgs.append(STATE_CHECKS[-1])
        errs += [f"env {b}: {m}" for m in msgs]
    return errs


def validate_state(state: WarehouseState, config: WarehouseConfig) -> None:
    """Raise ValueError when an env of the state violates the engine's
    invariants (the first ten messages, and how many more)."""
    errs = state_invariant_errors(state, config)
    if errs:
        more = f"; and {len(errs) - 10} more" if len(errs) > 10 else ""
        raise ValueError("invalid WarehouseState: " + "; ".join(errs[:10]) + more)


class CheckError(RuntimeError):
    """A check of :func:`checked_step` failed."""


class StepChecks:
    """The post-step checks of one step, on the device until asked:
    ``get()`` brings them to the host (one copy) and returns the message of
    the first failed check or None; ``throw()`` raises :class:`CheckError`
    with it, as checkify's ``Error`` does."""

    def __init__(self, failed: torch.Tensor):
        self._failed = failed  # (B, len(STEP_CHECKS)) bool
        self._message: Optional[str] = None
        self._read = False

    def get(self) -> Optional[str]:
        if not self._read:
            failed = to_host(self._failed)[0]
            for k, name in enumerate(STEP_CHECKS):
                envs = np.flatnonzero(failed[:, k])
                if envs.size:
                    self._message = f"{name} (envs {envs[:8].tolist()}" + (
                        f" and {envs.size - 8} more)" if envs.size > 8 else ")")
                    break
            self._read = True
        return self._message

    def throw(self) -> None:
        message = self.get()
        if message is not None:
            raise CheckError(message)


def checked_step(step_fn: Callable, config: WarehouseConfig) -> Callable:
    """Wrap a step function with the post-step invariant checks.

    Returns ``checked(state, actions, *args) -> (err, result)``: the step's
    result and a :class:`StepChecks`; call ``err.throw()`` to surface a
    violation.  ``step_fn(state, actions, *args)`` returns a ``StepResult``
    (``Warehouse.step`` with its generator, or ``Warehouse._step_fn``).
    """
    def checked(state: WarehouseState, actions: torch.Tensor, *args, **kwargs):
        result = step_fn(state, actions, *args, **kwargs)
        new = result.state
        shared = _has_duplicate(_cells(new.agent_x, new.agent_y))
        drift = _misplaced_carried(new, config.n_shelves).any(dim=1)
        return StepChecks(torch.stack([shared, drift], dim=1)), result

    return checked
