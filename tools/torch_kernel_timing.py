#!/usr/bin/env python3
"""Time the port's fused kernels on a CUDA GPU and show where a main-path
call spends its device time.

For each config: the fused rollout kernel (K1, random mode) at B=65,536,
T=256, and the fused collector kernel (K2a, hidden (128, 128)) at
B=16,384, T=128.  Each timing is the median of ``--repeats`` launches timed
with CUDA events after one warm-up launch, with the spread (min, max) beside
it.  ``--profile`` adds one torch.profiler window per kernel on tiny-2ag:
device time by kernel name and the device-busy share of the call's wall
time.  Prints one JSON object per line, each with the card's name and power
limit; ``--out`` also writes them to a file.

Usage: python tools/torch_kernel_timing.py [--configs ...] [--profile] [--out FILE]
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def time_launches(fn, repeats):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), min(times), max(times)


def profile(fn):
    """(device ms by kernel name, device-busy share of the wall window)."""
    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for evt in prof.key_averages():
        # Device-side events only: a host op's device time repeats its kernels'.
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            name = evt.key[:80]
            by_name[name] = by_name.get(name, 0.0) + dev_us / 1e3
    busy = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return top, busy, wall_ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="+", default=[
        "rware-tiny-2ag-v2", "rware-small-4ag-v2", "rware-medium-6ag-hard-v2",
        "rware-large-8ag-v2", "rware-tiny-16ag-v2"])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    import rware_tpu_torch
    from rware_tpu_torch.models import ActorCritic
    from rware_tpu_torch.ops.fused_rollout import build_fused_collect, build_fused_rollout
    from rware_tpu_torch.parallel import batched_reset

    dev = torch.device("cuda:0")
    device = {"kind": torch.cuda.get_device_name(0), "nvidia_smi": card()}
    lines = []

    def emit(rec):
        rec["device"] = device
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    for env_id in args.configs:
        env = rware_tpu_torch.make(env_id, device=dev)
        b, t = 65536, 256
        states, _ = batched_reset(env, 0, b)
        roll = build_fused_rollout(env.config, t)
        med, lo, hi = time_launches(lambda: roll(states, 1), args.repeats)
        emit({"kernel": "fused_rollout", "env": env_id, "B": b, "T": t, "ms_median": med,
              "ms_min": lo, "ms_max": hi, "env_steps_per_s": b * t / med * 1e3})
        b, t = 16384, 128
        states, _ = batched_reset(env, 0, b)
        torch.manual_seed(0)
        policy = ActorCritic(env.config.flattened_obs_length).to(dev)
        collect = build_fused_collect(env.config, t)
        med, lo, hi = time_launches(lambda: collect(states, policy, 1), args.repeats)
        emit({"kernel": "fused_collect", "env": env_id, "B": b, "T": t, "ms_median": med,
              "ms_min": lo, "ms_max": hi, "env_steps_per_s": b * t / med * 1e3})

    if args.profile:
        env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=dev)
        states, _ = batched_reset(env, 0, 65536)
        roll = build_fused_rollout(env.config, 256)
        top, busy, wall = profile(lambda: roll(states, 1))
        emit({"profile": "fused_rollout call", "device_ms_by_kernel": top,
              "device_busy_ms": busy, "wall_ms": wall})
        states, _ = batched_reset(env, 0, 16384)
        policy = ActorCritic(env.config.flattened_obs_length).to(dev)
        collect = build_fused_collect(env.config, 128)
        top, busy, wall = profile(lambda: collect(states, policy, 1))
        emit({"profile": "fused_collect call", "device_ms_by_kernel": top,
              "device_busy_ms": busy, "wall_ms": wall})
    emit({"nvidia_smi_after": card()})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
