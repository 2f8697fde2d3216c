"""Metrics (the counterpart of ``rware_tpu/metrics.py``'s ``MetricLogger``):
the host-side aggregator of ``train``'s logging loop.
"""
from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np


class MetricLogger:
    """Host-side running aggregator with steps/s accounting.

    ``log(step, metrics, env_steps)`` takes a dict of device or host scalars;
    the values are fetched once (one device-to-host sync per call) and kept,
    with the wall time since the logger was made and ``env_steps`` over the
    time since the previous call.  Every ``print_every``-th step is printed."""

    def __init__(self, print_every: int = 0):
        self.history: list = []
        self.print_every = print_every
        self._t0 = time.perf_counter()
        self._last_time = self._t0

    def log(self, step: int, metrics: Dict[str, Any], env_steps: int = 0) -> dict:
        entry = {k: float(v) for k, v in metrics.items()}
        now = time.perf_counter()
        entry["step"] = step
        entry["wall_s"] = now - self._t0
        if env_steps:
            entry["env_steps_per_s"] = env_steps / max(now - self._last_time, 1e-9)
        self._last_time = now
        self.history.append(entry)
        if self.print_every and step % self.print_every == 0:
            print("  ".join([f"step {step}"] + [f"{k}={v:.4g}" for k, v in entry.items()
                                                if k != "step"]), flush=True)
        return entry

    def summary(self) -> dict:
        """Means over the logged entries of every key of the last one."""
        if not self.history:
            return {}
        keys = [k for k in self.history[-1] if k != "step"]
        return {k: float(np.mean([h[k] for h in self.history if k in h])) for k in keys}
