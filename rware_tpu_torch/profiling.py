"""Profiling hooks on ``torch.profiler`` (the counterpart of
``rware_tpu/profiling.py``): traces of a code block or of a window of loop
steps, named annotations, wall-clock timers that wait for the device, step
statistics, and the reduction of scalar metrics across processes.

``trace(dir, device)`` and :class:`TraceWindow` write a Chrome trace
(``<dir>/<host>_<pid>.<ns>.pt.trace.json``, which TensorBoard and Perfetto
open) by ``torch.profiler.tensorboard_trace_handler``.  The device's events
are traced where the ``device`` given is a CUDA device; it is never chosen by
probing for a card.  On a CUDA device the timers and the trace window call
``torch.cuda.synchronize(device)`` where JAX's wait for the device
(``jax.effects_barrier`` / ``block_until_ready``); on the CPU the work is done
when the call returns.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


def _activities(device) -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def _sync(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU or with no device)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _profiler(log_dir: str, device):
    from torch.profiler import profile, tensorboard_trace_handler

    return profile(activities=_activities(device),
                   on_trace_ready=tensorboard_trace_handler(log_dir))


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[None]:
    """Trace the block into ``log_dir``; with a CUDA ``device`` its kernels
    and copies too (the block's queued work is waited for before the trace
    stops)."""
    with _profiler(log_dir, device):
        yield
        _sync(device)


def annotate(name: str):
    """Scope the ops of a block under ``name`` in profiler traces."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def stopwatch(label: str, sync: bool = True, device=None) -> Iterator[None]:
    """Host-side wall-clock timer; with ``sync`` it waits for ``device``'s
    queued work before it reads the clock."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _sync(device)
        print(f"[{label}] {time.perf_counter() - t0:.4f}s", flush=True)


def throughput(fn, *args, repeats: int = 3, items: Optional[int] = None, device=None):
    """Best-of-N wall time of ``fn(*args)`` after one warm-up call, each call
    waited for on ``device``; returns (seconds, items/s or None)."""
    fn(*args)
    _sync(device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best, (items / best if items else None)


class StepTimer:
    """Rolling per-step wall-time stats for training/bench loops.

    Call ``tick()`` once per completed step; ``summary()`` reports mean /
    p50 / p95 milliseconds and steps/s over the recorded window (compile
    steps can be excluded with ``skip_first``).
    """

    def __init__(self, skip_first: int = 1, window: int = 512):
        self._skip = skip_first
        self._window = window
        self._durations: list = []
        self._last: Optional[float] = None

    def tick(self, n_steps: int = 1, record: bool = True) -> None:
        """Record the time since the previous tick as ``n_steps`` equal
        steps (pass n_steps>1 when ticking only at host-sync boundaries
        that cover several train steps).  ``record=False`` restarts the
        clock without recording, for steps that should not count (traced
        ones); such a window counts as one of the first ones skipped."""
        now = time.perf_counter()
        if self._last is not None:
            if self._skip > 0:
                self._skip -= 1
            elif record:
                self._durations.append((now - self._last) / max(n_steps, 1))
                if len(self._durations) > self._window:
                    self._durations.pop(0)
        self._last = now

    def summary(self) -> dict:
        if not self._durations:
            return {}
        import numpy as np

        d = np.asarray(self._durations)
        return {
            "step_ms_mean": float(d.mean() * 1e3),
            "step_ms_p50": float(np.percentile(d, 50) * 1e3),
            "step_ms_p95": float(np.percentile(d, 95) * 1e3),
            "steps_per_s": float(1.0 / d.mean()),
        }


def aggregate_across_hosts(metrics: dict, reduce: str = "mean") -> dict:
    """Reduce scalar metrics across the processes of a ``torch.distributed``
    run (``mean`` or ``sum``); every process receives the reduced dict.

    Without an initialised process group the metrics come back unchanged, as
    floats.  Otherwise one ``all_reduce`` of a float64 vector, the values in
    sorted key order, on the group's device (the current CUDA device under
    NCCL, else the CPU); every process must pass the same keys."""
    if reduce not in ("mean", "sum"):
        raise ValueError(f"reduce must be 'mean' or 'sum', got {reduce!r}")
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    vec = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64, device=dev)
    dist.all_reduce(vec)
    if reduce == "mean":
        vec /= dist.get_world_size()
    return {k: float(v) for k, v in zip(keys, vec.tolist())}


class TraceWindow:
    """Automatic trace artifact for a window of loop steps.

    Traces steps ``[start, start + n_steps)`` into ``log_dir`` (after the
    build and warm-up, short enough to stay viewable) without wrapping the
    whole run; with a CUDA ``device`` the device's events too, its queued
    work waited for before the trace stops.  Call ``step(idx)`` once per
    loop iteration, before the step's work; ``close()`` is safe to call any
    time.
    """

    def __init__(self, log_dir: str, start: int = 3, n_steps: int = 3, device=None):
        self.log_dir = log_dir
        self.start = start
        self.stop = start + n_steps
        self.device = device
        self._prof = None
        self._done = False

    def step(self, idx: int) -> None:
        if self._done:
            return
        if self._prof is None and idx >= self.start:
            self._prof = _profiler(self.log_dir, self.device)
            self._prof.start()
        elif self._prof is not None and idx >= self.stop:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            _sync(self.device)
            self._prof.stop()
            self._prof = None
            self._done = True
