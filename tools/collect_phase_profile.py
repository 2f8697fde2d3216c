#!/usr/bin/env python3
"""Where the MLP collector kernel spends its time, phase by phase, on a CUDA GPU.

Copies this checkout's ``rware_tpu_torch`` into ``--work-dir`` and defines the
phase counters of ``csrc/fused_collect.cu`` (``RW_COLLECT_MARK*``, empty in
the checkout) with the SM's clock, read as a memory operation: thread 0 of each block (an env thread)
reads the clock after each barrier of a step, so a phase's cycles are the
block's wall cycles in it, the other block on the SM included:

- observations: a thread a row builds its row from its env's view (beside
  them, other threads store the last step's rewards and done flags);
- dense_0 and dense_1: the block product of each hidden layer (the step's
  observations are stored in dense_0, before h1 goes over them);
- heads: the f32 policy, value and message rows;
- sampling: one thread a row;
- env step: the env threads step and write their views (beside them, the
  other threads store the step's action, logp, value and bits).

The stores run on threads other than thread 0, beside the phases named, so
they take no phase of their own here.  The copy is built once, and K2a, K2a with K2b (two message bits), K2a with
K2e (``rware-img-tiny-2ag-v2``) and K2d (each agent its own network) are
launched at B=16,384, T=128, hidden (128, 128); for each the script prints
one JSON line: the share of each phase, the cycles of one step of a tile,
the kernel's time (CUDA events) and the card's name and power limit.  The counters change the
kernel's timing a little; the checkout itself is not touched.

Usage: python tools/collect_phase_profile.py [--work-dir DIR] [--repeats N]
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ["observations (| rewards out)", "dense_0", "dense_1", "heads", "sampling",
          "env step (| action, logp, value, bits out)"]
COUNTERS = """// the clock read as a memory operation, so that it stays beside its barrier
static __device__ __forceinline__ long long rw_clock_() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
  return t;
}
#define RW_COLLECT_MARK(i) { const long long t_ = rw_clock_(); \\
    if (threadIdx.x == 0) prof_[i] += t_ - prev_; prev_ = t_; }
#define RW_COLLECT_MARK_INIT long long prof_[6] = {0, 0, 0, 0, 0, 0}; \\
    long long prev_ = rw_clock_();
#define RW_COLLECT_MARK_END if (threadIdx.x == 0) \\
    for (int i_ = 0; i_ < 6; ++i_) atomicAdd(&g_collect_prof[i_], (unsigned long long)prof_[i_]);
__device__ unsigned long long g_collect_prof[6];
"""


def patch(work: str) -> None:
    """Define the phase counters in the copy's collector and add an accessor
    to its library."""
    p = os.path.join(work, "rware_tpu_torch", "csrc", "fused_collect.cu")
    s = open(p).read()
    anchor = '#include "collect_core.cuh"\n'
    if anchor not in s or "RW_COLLECT_MARK_INIT;" not in s:
        raise SystemExit("the phase counters' hooks not found in fused_collect.cu")
    s = s.replace(anchor, anchor + COUNTERS, 1)
    s += ("\nextern \"C\" int rw_collect_prof(unsigned long long* out) {\n"
          "  cudaError_t e = cudaMemcpyFromSymbol(out, g_collect_prof, 6 * sizeof(unsigned long long));\n"
          "  unsigned long long z[6] = {0};\n"
          "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_collect_prof, z, sizeof(z));\n"
          "  return (int)e;\n}\n")
    open(p, "w").write(s)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--work-dir", default=os.path.join(ROOT, "build", "collect_phase_profile"))
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    work = os.path.abspath(args.work_dir)
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "rware_tpu_torch"), os.path.join(work, "rware_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    patch(work)
    sys.path.insert(0, work)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    import rware_tpu_torch
    from rware_tpu_torch.models.networks import init_actor_critic
    from rware_tpu_torch.ops._build import load_library
    from rware_tpu_torch.ops.fused_rollout import (
        build_fused_collect,
        build_fused_collect_per_agent,
    )
    from rware_tpu_torch.parallel import batched_reset

    dev = torch.device("cuda:0")
    lib = load_library()
    lib.rw_collect_prof.argtypes = [ctypes.c_void_p]
    counts = (ctypes.c_ulonglong * 6)()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    b, t = 16384, 128
    for name, env_id, m, per_agent in (("K2a", "rware-tiny-2ag-v2", 0, False),
                                       ("K2a with K2b", "rware-tiny-2ag-v2", 2, False),
                                       ("K2a with K2e", "rware-img-tiny-2ag-v2", 0, False),
                                       ("K2d", "rware-tiny-2ag-v2", 0, True)):
        env = rware_tpu_torch.make(env_id, device=dev, msg_bits=m)
        states, _ = batched_reset(env, 0, b)
        length = env.config.policy_obs_length
        if per_agent:
            policy = torch.nn.ModuleList(init_actor_critic(length, 5, (128, 128), (0, 2, i), m)
                                         for i in range(env.n_agents)).to(dev)
            collect = build_fused_collect_per_agent(env.config, t)
        else:
            policy = init_actor_critic(length, 5, (128, 128), 0, m).to(dev)
            collect = build_fused_collect(env.config, t)
        collect(states, policy, 1)
        torch.cuda.synchronize()
        lib.rw_collect_prof(ctypes.addressof(counts))  # zero the counters
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.repeats):
            collect(states, policy, 1)
        end.record()
        torch.cuda.synchronize()
        if lib.rw_collect_prof(ctypes.addressof(counts)) != 0:
            raise SystemExit("reading the counters failed")
        total = float(sum(counts[:len(PHASES)]))
        plan = collect.plan
        steps = args.repeats * plan.blocks(b) * t
        print(json.dumps({
            "kernel": name, "env": env_id, "msg_bits": m, "B": b, "T": t,
            "plan": {"te": plan.te, "threads": plan.threads, "smem": plan.smem,
                     "blocks_per_sm": plan.blocks_per_sm, "weights_global": plan.weights_global},
            "ms": start.elapsed_time(end) / args.repeats,
            "cycles_a_step_a_block": total / steps,
            "phase_share": {p: counts[i] / total for i, p in enumerate(PHASES)},
            "device": card}), flush=True)
        del states, policy, collect
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
