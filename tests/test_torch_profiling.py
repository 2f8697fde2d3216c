"""The port's profiling hooks on the CPU device (the counterpart of
``tests/test_profiling.py``): ``trace`` and ``TraceWindow`` write a Chrome
trace, ``throughput`` returns a rate, ``stopwatch`` prints, ``StepTimer``
summarises and leaves out a window it is told not to record,
``aggregate_across_hosts`` passes a single process's metrics through; and
``train --profile-dir`` writes a trace of updates [3, 6) and the "timing:"
line without the traced windows.  The one number compared is a timer's p95
under 100 ms once a 200 ms window is left out; the device's events are
traced only on the card (``chip_smoke.py`` phase 30)."""
import json
import os
import time

import pytest
import torch

from rware_tpu_torch import train
from rware_tpu_torch.profiling import (
    StepTimer,
    TraceWindow,
    aggregate_across_hosts,
    annotate,
    stopwatch,
    throughput,
    trace,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def trace_files(path):
    return sorted(p for p in path.rglob("*.pt.trace.json"))


def event_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_writes_artifacts(tmp_path):
    with trace(str(tmp_path), CPU):
        with annotate("test-compute"):
            torch.arange(1000.0).sum()
    files = trace_files(tmp_path)
    assert len(files) == 1, "no trace artifacts written"
    assert "test-compute" in event_names(files[0])


def test_throughput_returns_rate():
    x = torch.arange(1024.0)
    secs, rate = throughput(lambda v: (v * 2).sum(), x, repeats=2, items=1024, device=CPU)
    assert secs > 0
    assert rate > 0
    assert throughput(lambda v: v + 1, x, repeats=1)[1] is None


def test_stopwatch_prints(capsys):
    with stopwatch("unit", device=CPU):
        torch.arange(10).sum()
    assert "[unit]" in capsys.readouterr().out


def test_step_timer_summary():
    t = StepTimer(skip_first=1)
    for _ in range(5):
        t.tick()
    s = t.summary()
    assert set(s) == {"step_ms_mean", "step_ms_p50", "step_ms_p95", "steps_per_s"}
    assert s["steps_per_s"] > 0
    assert StepTimer(skip_first=1).summary() == {}


def test_step_timer_leaves_out_unrecorded_windows():
    t = StepTimer(skip_first=0)
    t.tick()
    time.sleep(0.2)
    t.tick(record=False)  # the slow window is not recorded
    t.tick()
    assert t.summary()["step_ms_p95"] < 100
    t = StepTimer(skip_first=1)
    t.tick()
    t.tick(record=False)  # takes the place of the skipped first window
    assert t.summary() == {}
    t.tick()
    assert t.summary()["steps_per_s"] > 0


def test_aggregate_across_hosts_single_process():
    out = aggregate_across_hosts({"a": 1.5, "b": torch.tensor(2)})
    assert out == {"a": 1.5, "b": 2.0}
    with pytest.raises(ValueError, match="reduce"):
        aggregate_across_hosts({"a": 1.0}, reduce="max")


def test_trace_window_writes_artifacts(tmp_path):
    tw = TraceWindow(str(tmp_path), start=1, n_steps=2, device=CPU)
    for i in range(5):
        tw.step(i)
        with annotate(f"step-{i}"):
            float((torch.arange(8.0) * 2).sum())
    tw.close()
    files = trace_files(tmp_path)
    assert len(files) == 1, "trace window produced no artifacts"
    names = event_names(files[0])
    assert {"step-1", "step-2"} <= names and not names & {"step-0", "step-3", "step-4"}


def test_train_profile_dir_writes_a_trace_and_the_timing_line(tmp_path, capsys):
    prof = tmp_path / "prof"
    train.main(["--algo", "seac", "--device", "cpu", "--n-envs", "16", "--updates", "8",
                "--log-every", "2", "--profile-dir", str(prof)])
    out = capsys.readouterr().out
    files = trace_files(prof)
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    timing = [line for line in out.splitlines() if line.startswith("timing:")]
    assert len(timing) == 1 and "p50 /" in timing[0] and "p95 per update" in timing[0]
    assert "env-steps/s; traced updates left out" in timing[0]
