#!/usr/bin/env python3
"""Where the collector kernels spend their time, phase by phase, on a CUDA GPU.

Copies this checkout's ``rware_tpu_torch`` into ``--work-dir`` and defines the
phase counters of ``csrc/fused_collect.cu`` (``RW_COLLECT_MARK*``) and of
``csrc/collect_gru.cuh`` (``RW_COLLECT_GRU_MARK*``), empty in the checkout,
with the SM's clock, read as a memory operation: thread 0 of each block (an
env thread) reads the clock after each barrier of a step, so a phase's cycles
are the block's wall cycles in it, the other block on the SM included.  The
MLP collector's phases (K2a, K2d):

- observations: a thread a row builds its row from its env's view (beside
  them, other threads store the last step's rewards and done flags);
- dense_0 and dense_1: the block product of each hidden layer (the step's
  observations are stored in dense_0, before h1 goes over them);
- heads: the f32 policy, value and message rows;
- sampling: one thread a row;
- env step: the env threads step and write their views (beside them, the
  other threads store the step's action, logp, value and bits).

The recurrent collector's (K2c, K2d′): observations (and the carry zeroed
where an episode ended), embed (the obs stored before e goes over them),
gates (the cell's input and hidden products and new h), heads, sampling, env
step, each as above.

The stores run on threads other than thread 0, beside the phases named, so
they take no phase of their own here.  The copy is built once, and K2a, K2a
with K2b (two message bits), K2a with K2e (``rware-img-tiny-2ag-v2``) and K2d
(each agent its own network) are launched at B=16,384, T=128, hidden (128,
128); K2c, K2c with K2b and K2c with K2e at B=16,384 and K2d′ at B=4,096, T=128,
embed and GRU width 128; for each the script prints one JSON line: the share
of each phase, the cycles of one step of a tile, the kernel's time (CUDA
events), its plan and the card's name and power limit.  The counters change
the kernels' timing a little; the checkout itself is not touched.

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
GRU_PHASES = ["observations (| rewards out)", "embed", "gates", "heads", "sampling",
              "env step (| action, logp, value, bits out)"]
COUNTERS = """// the clock read as a memory operation, so that it stays beside its barrier
static __device__ __forceinline__ long long rw_clock_() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
  return t;
}
#define MARK(i) { const long long t_ = rw_clock_(); \\
    if (threadIdx.x == 0) prof_[i] += t_ - prev_; prev_ = t_; }
#define MARK_INIT long long prof_[6] = {0, 0, 0, 0, 0, 0}; \\
    long long prev_ = rw_clock_();
#define MARK_END if (threadIdx.x == 0) \\
    for (int i_ = 0; i_ < 6; ++i_) atomicAdd(&SYM[i_], (unsigned long long)prof_[i_]);
static __device__ unsigned long long SYM[6];
"""
ACCESSOR = """
extern "C" int FN(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, SYM, 6 * sizeof(unsigned long long));
  unsigned long long z[6] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(SYM, z, sizeof(z));
  return (int)e;
}
"""
# (source with the hooks, the line after which the counters go, macro prefix,
# counters' symbol, {source: accessor} reading that symbol in its unit)
PATCHES = [
    ("fused_collect.cu", '#include "collect_core.cuh"\n', "RW_COLLECT_MARK", "g_collect_prof",
     {"fused_collect.cu": "rw_collect_prof"}),
    ("collect_gru.cuh", '#include "gru_core.cuh"  // gru_sigmoid\n', "RW_COLLECT_GRU_MARK",
     "g_collect_gru_prof", {"fused_collect_gru.cu": "rw_collect_gru_prof",
                            "fused_collect_gru_image.cu": "rw_collect_gru_image_prof"}),
]


def patch(work: str) -> None:
    """Define the phase counters in the copy's collectors and add accessors
    to its library (one for each translation unit the counters live in)."""
    csrc = os.path.join(work, "rware_tpu_torch", "csrc")
    for src, anchor, prefix, sym, accessors in PATCHES:
        p = os.path.join(csrc, src)
        s = open(p).read()
        if anchor not in s or f"{prefix}_INIT;" not in s:
            raise SystemExit(f"the phase counters' hooks not found in {src}")
        counters = COUNTERS.replace("MARK", prefix).replace("SYM", sym)
        open(p, "w").write(s.replace(anchor, anchor + counters, 1))
        for unit, fn in accessors.items():
            with open(os.path.join(csrc, unit), "a") as f:
                f.write(ACCESSOR.replace("FN", fn).replace("SYM", sym))


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
    from rware_tpu_torch.models.networks import init_actor_critic, init_recurrent_actor_critic
    from rware_tpu_torch.ops._build import load_library
    from rware_tpu_torch.ops.fused_rollout import (
        build_fused_collect,
        build_fused_collect_gru,
        build_fused_collect_gru_per_agent,
        build_fused_collect_per_agent,
    )
    from rware_tpu_torch.parallel import batched_reset

    dev = torch.device("cuda:0")
    lib = load_library()
    for fn in ("rw_collect_prof", "rw_collect_gru_prof", "rw_collect_gru_image_prof"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    counts = (ctypes.c_ulonglong * 6)()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    t = 128
    # (name, env, message bits, batch, kind)
    runs = [("K2a", "rware-tiny-2ag-v2", 0, 16384, "mlp"),
            ("K2a with K2b", "rware-tiny-2ag-v2", 2, 16384, "mlp"),
            ("K2a with K2e", "rware-img-tiny-2ag-v2", 0, 16384, "mlp"),
            ("K2d", "rware-tiny-2ag-v2", 0, 16384, "mlp_per_agent"),
            ("K2c", "rware-tiny-2ag-v2", 0, 16384, "gru"),
            ("K2c with K2b", "rware-tiny-2ag-v2", 2, 16384, "gru"),
            ("K2c with K2e", "rware-img-tiny-2ag-v2", 0, 16384, "gru"),
            ("K2d′", "rware-tiny-2ag-v2", 0, 4096, "gru_per_agent")]
    for name, env_id, m, b, kind in runs:
        env = rware_tpu_torch.make(env_id, device=dev, msg_bits=m)
        states, _ = batched_reset(env, 0, b)
        length, n = env.config.policy_obs_length, env.n_agents
        per_agent = kind.endswith("per_agent")
        if kind.startswith("gru"):
            nets = [init_recurrent_actor_critic(length, 5, 128, 128, (0, 2, i), m)
                    for i in range(n if per_agent else 1)]
            collect = (build_fused_collect_gru_per_agent if per_agent
                       else build_fused_collect_gru)(env.config, t)
            plan = collect.plan(b)
            extra = (nets[0].initialize_carry((b, n)).to(dev),)
            read = lib.rw_collect_gru_image_prof if "K2e" in name else lib.rw_collect_gru_prof
            phases = GRU_PHASES
        else:
            nets = [init_actor_critic(length, 5, (128, 128), (0, 2, i), m)
                    for i in range(n if per_agent else 1)]
            collect = (build_fused_collect_per_agent if per_agent
                       else build_fused_collect)(env.config, t)
            plan, extra, read, phases = collect.plan, (), lib.rw_collect_prof, PHASES
        policy = torch.nn.ModuleList(nets).to(dev) if per_agent else nets[0].to(dev)
        collect(states, policy, 1, *extra)
        torch.cuda.synchronize()
        read(ctypes.addressof(counts))  # zero the counters
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.repeats):
            collect(states, policy, 1, *extra)
        end.record()
        torch.cuda.synchronize()
        if read(ctypes.addressof(counts)) != 0:
            raise SystemExit("reading the counters failed")
        total = float(sum(counts[:len(phases)]))
        steps = args.repeats * plan.blocks(b) * t
        print(json.dumps({
            "kernel": name, "env": env_id, "msg_bits": m, "B": b, "T": t,
            "plan": {"te": plan.te, "threads": plan.threads, "smem": plan.smem,
                     "blocks_per_sm": plan.blocks_per_sm, "weights_global": plan.weights_global},
            "ms": start.elapsed_time(end) / args.repeats,
            "cycles_a_step_a_block": total / steps,
            "phase_share": {p: counts[i] / total for i, p in enumerate(phases)},
            "device": card}), flush=True)
        del states, policy, collect
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
