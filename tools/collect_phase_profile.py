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

``--rollout`` profiles the fused rollout kernel (K1) instead, from the
checkout ``--tree`` (this one by default; an unpacked older commit for a
before and after).  It builds ``csrc/fused_rollout.cu`` of that tree alone with
``nvcc`` (``ptxas -v`` gives the kernels' registers, stack frame and spills),
twice: as it is, and with K1's phase counters (``RW_ROLLOUT_MARK*``, empty in
the checkout; a tree without them, the one-thread-an-env kernel on the
local-memory ``EnvState``, gets the same marks added in the copy).  Each
thread reads the clock after each phase and lane 0 of each warp adds its
cycles up, so a phase's cycles are a warp's wall cycles in it.  K1's phases:

- draws: the step's moves and message bits (Philox, or the scripted columns),
  and the last step's reward sums added up;
- pre-cancel: the targets, and a loaded agent's move onto a standing shelf;
- resolver: the collision resolver (``resolve_moves``);
- moves and toggles: moves, turns, the carried shelves, pick-ups and drops;
- deliveries: the shelves on the goals, the queue's replacement and rewards;
- termination and reset: the counters, and autoreset where an episode ends;
- state load and store: the packed state in and out, the sums out.

The tree's wrapper (``build_fused_rollout``) launches the library built here
at B=65,536, T=256 on each of ``--configs`` (tiny-2ag) with each of
``--msg-bits`` (0 and 2), random mode; for each the script prints one JSON
line: the time with and without the counters (CUDA events, median of
``--repeats``), each phase's share, the cycles of an env step of a warp, the
launch plan where the tree has one, ``ptxas``'s report and the card's name
and power limit.

Usage: python tools/collect_phase_profile.py [--work-dir DIR] [--repeats N]
       python tools/collect_phase_profile.py --rollout [--tree DIR] [--configs ID ...]
       [--msg-bits M ...] [--work-dir DIR] [--repeats N]
"""
import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
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
    ("collect_mlp.cuh", '#include "collect_core.cuh"\n', "RW_COLLECT_MARK", "g_collect_prof",
     {"fused_collect.cu": "rw_collect_prof",
      "fused_collect_chunked.cu": "rw_collect_chunked_prof"}),
    ("collect_gru.cuh", '#include "gru_core.cuh"  // gru_sigmoid\n', "RW_COLLECT_GRU_MARK",
     "g_collect_gru_prof", {"fused_collect_gru.cu": "rw_collect_gru_prof",
                            "fused_collect_gru_one_stack.cu": "rw_collect_gru_one_stack_prof",
                            "fused_collect_gru_image.cu": "rw_collect_gru_image_prof",
                            "fused_collect_gru_image_one_stack.cu":
                                "rw_collect_gru_image_one_stack_prof",
                            "fused_collect_gru_chunked.cu": "rw_collect_gru_chunked_prof",
                            "fused_collect_gru_chunked_image.cu":
                                "rw_collect_gru_chunked_image_prof"}),
]

ROLLOUT_PHASES = ["draws", "pre-cancel", "resolver", "moves and toggles", "deliveries",
                  "termination and reset", "state load and store"]
ROLLOUT_COUNTERS = """// K1's phase counters: the clock read as a memory operation
static __device__ __forceinline__ long long rw_clock_() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
  return t;
}
#define RW_ROLLOUT_MARK(i) { const long long t_ = rw_clock_(); prof_[i] += t_ - prev_; prev_ = t_; }
#define RW_ROLLOUT_MARK_INIT long long prof_[7] = {0, 0, 0, 0, 0, 0, 0}; \\
    long long prev_ = rw_clock_();
#define RW_ROLLOUT_MARK_END if ((threadIdx.x & 31) == 0) \\
    for (int i_ = 0; i_ < 7; ++i_) atomicAdd(&g_rollout_prof[i_], (unsigned long long)prof_[i_]);
static __device__ unsigned long long g_rollout_prof[7];
"""
ROLLOUT_ACCESSOR = """
extern "C" int rw_rollout_prof(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_rollout_prof, 7 * sizeof(unsigned long long));
  unsigned long long z[7] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_rollout_prof, z, sizeof(z));
  return (int)e;
}
"""
# The same marks in a tree whose K1 has no hooks (the one-thread-an-env kernel
# on the local-memory EnvState): (file, text, text with marks).
# env_step takes the counters as two more arguments; only K1 is built here.
ROLLOUT_PARENT_MARKS = [
    ("env_core.cuh", "const EnvLayout& lay, uint32_t env, uint32_t step) {",
     "const EnvLayout& lay, uint32_t env, uint32_t step,\n"
     "                                long long* prof_, long long& prev_) {"),
    ("env_core.cuh", "  resolve_moves(N, acell, tcell, committed);\n",
     "  RW_ROLLOUT_MARK(1)\n  resolve_moves(N, acell, tcell, committed);\n  RW_ROLLOUT_MARK(2)\n"),
    ("env_core.cuh", "  // Deliveries, queue resample and rewards, goal by goal.\n",
     "  RW_ROLLOUT_MARK(3)\n  // Deliveries, queue resample and rewards, goal by goal.\n"),
    ("env_core.cuh", "  // Termination and autoreset.\n",
     "  RW_ROLLOUT_MARK(4)\n  // Termination and autoreset.\n"),
    ("env_core.cuh", "    for (int k = 0; k < N * d.m; ++k) st.msg[k] = 0;\n  }\n  return done;\n",
     "    for (int k = 0; k < N * d.m; ++k) st.msg[k] = 0;\n  }\n  RW_ROLLOUT_MARK(5)\n"
     "  return done;\n"),
    ("fused_rollout.cu", "  const EnvLayout lay = make_layout(d, layout);\n",
     "  RW_ROLLOUT_MARK_INIT\n  const EnvLayout lay = make_layout(d, layout);\n"),
    ("fused_rollout.cu", "  load_state(st, d, state_in, e, B);\n",
     "  load_state(st, d, state_in, e, B);\n  RW_ROLLOUT_MARK(6)\n"),
    ("fused_rollout.cu", "    bool done = env_step(st, acts, rew, d, lay, e, t);\n",
     "    RW_ROLLOUT_MARK(0)\n    bool done = env_step(st, acts, rew, d, lay, e, t, prof_, prev_);\n"),
    ("fused_rollout.cu", "  episodes[e] = epis;\n}\n",
     "  episodes[e] = epis;\n  RW_ROLLOUT_MARK(6)\n  RW_ROLLOUT_MARK_END\n}\n"),
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


def rollout_build(work: str, tree: str, counters: bool):
    """(nvcc command, library path) of one build of ``tree``'s K1 source
    alone, with its phase counters or without."""
    sys.path.insert(0, tree)
    from rware_tpu_torch.ops._build import NVCC_FLAGS, _nvcc

    csrc = os.path.join(tree, "rware_tpu_torch", "csrc")
    out_dir = os.path.join(work, "k1_prof" if counters else "k1")
    os.makedirs(out_dir)
    srcs = {f: open(os.path.join(csrc, f)).read() for f in ("env_core.cuh", "fused_rollout.cu")}
    if counters:
        if "RW_ROLLOUT_MARK_INIT" not in srcs["fused_rollout.cu"]:
            for f, old, new in ROLLOUT_PARENT_MARKS:
                if srcs[f].count(old) != 1:
                    raise SystemExit(f"K1's phase marks: no single place for {old!r} in {f}")
                srcs[f] = srcs[f].replace(old, new)
        anchor = '#include "env_core.cuh"\n'
        if anchor not in srcs["fused_rollout.cu"]:
            raise SystemExit("the phase counters' hooks not found in fused_rollout.cu")
        srcs["fused_rollout.cu"] = srcs["fused_rollout.cu"].replace(
            anchor, ROLLOUT_COUNTERS + anchor, 1) + ROLLOUT_ACCESSOR
    for f, text in srcs.items():
        with open(os.path.join(out_dir, f), "w") as fh:
            fh.write(text)
    lib = os.path.join(out_dir, "libk1.so")
    return [_nvcc(), *NVCC_FLAGS, "-I", out_dir, "-shared", "-o", lib,
            os.path.join(out_dir, "fused_rollout.cu")], lib


def ptxas_report(log: str) -> list:
    """Each kernel's registers, stack frame and spills from ``ptxas -v``."""
    pat = re.compile(r"Compiling entry function '([^']+)'.*?(\d+) bytes stack frame, (\d+) bytes "
                     r"spill stores, (\d+) bytes spill loads.*?Used (\d+) registers", re.S)
    return [{"kernel": m.group(1), "registers": int(m.group(5)),
             "stack_frame": int(m.group(2)), "spill_stores": int(m.group(3)),
             "spill_loads": int(m.group(4))} for m in pat.finditer(log)]


def rollout_main(args, card: str) -> None:
    """K1's phase profile (see the module's docstring)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    tree = os.path.abspath(args.tree)
    work = os.path.abspath(args.work_dir)
    jobs = [(counters, *rollout_build(work, tree, counters)) for counters in (False, True)]
    procs = [(c, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)) for c, cmd, lib in jobs]
    libs, logs = {}, {}
    for counters, path, proc in procs:
        logs[counters] = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed:\n{logs[counters][-4000:]}")
        libs[counters] = ctypes.CDLL(path)

    import rware_tpu_torch
    from rware_tpu_torch.ops import _build, fused_rollout
    from rware_tpu_torch.parallel import batched_reset

    for lib in libs.values():
        lib.rw_fused_rollout.argtypes = _build._SIGNATURES["rw_fused_rollout"]
        lib.rw_fused_rollout.restype = ctypes.c_int
        lib.rw_error_string.argtypes = [ctypes.c_int]
        lib.rw_error_string.restype = ctypes.c_char_p
    libs[True].rw_rollout_prof.argtypes = [ctypes.c_void_p]
    counts = (ctypes.c_ulonglong * 7)()
    dev = torch.device("cuda:0")
    b, t = 65536, 256
    for env_id in args.configs:
        for m in args.msg_bits:
            env = rware_tpu_torch.make(env_id, device=dev, msg_bits=m)
            states, _ = batched_reset(env, 0, b)
            roll = fused_rollout.build_fused_rollout(env.config, t)
            res = {}
            for counters in (False, True):
                _build.load_library = lambda lib=libs[counters]: lib
                roll(states, 1)
                torch.cuda.synchronize()
                if counters:
                    libs[True].rw_rollout_prof(ctypes.addressof(counts))  # zero them
                times = []
                for r in range(args.repeats):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    roll(states, 2 + r)
                    end.record()
                    torch.cuda.synchronize()
                    times.append(start.elapsed_time(end))
                res[counters] = (statistics.median(times), min(times), max(times))
            if libs[True].rw_rollout_prof(ctypes.addressof(counts)) != 0:
                raise SystemExit("reading the counters failed")
            total = float(sum(counts))
            warps = args.repeats * -(-b // 32)
            plan = getattr(roll, "plan", None)
            plan = plan(b) if callable(plan) else plan
            print(json.dumps({
                "kernel": "fused_rollout (K1)", "tree": args.tree, "env": env_id, "msg_bits": m,
                "B": b, "T": t, "ms_median_min_max": res[False],
                "ms_with_counters": res[True], "cycles_an_env_step_a_warp": total / (warps * t),
                "phase_share": {p: counts[i] / total for i, p in enumerate(ROLLOUT_PHASES)},
                "plan": None if plan is None else {
                    "route": plan.route, "te": plan.te, "smem": plan.smem,
                    "rows": plan.rows, "blocks_per_sm": plan.blocks_per_sm},
                "ptxas": ptxas_report(logs[False]), "device": card}), flush=True)
            del states, roll
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--work-dir", default=os.path.join(ROOT, "build", "collect_phase_profile"))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--rollout", action="store_true",
                    help="profile the fused rollout kernel (K1) instead of the collectors")
    ap.add_argument("--tree", default=ROOT, help="--rollout: the checkout whose K1 is profiled")
    ap.add_argument("--configs", nargs="+", default=["rware-tiny-2ag-v2"])
    ap.add_argument("--msg-bits", nargs="+", type=int, default=[0, 2])
    args = ap.parse_args()
    if args.rollout:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", "-i", "0"], capture_output=True,
                              text=True, check=True).stdout.strip()
        shutil.rmtree(os.path.abspath(args.work_dir), ignore_errors=True)
        return rollout_main(args, card)
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
    for fn in ("rw_collect_prof", "rw_collect_gru_prof", "rw_collect_gru_one_stack_prof",
               "rw_collect_gru_image_one_stack_prof"):
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
            # the accessor of the unit that holds the instantiation (K2d′ or K2c's)
            read = getattr(lib, "rw_collect_gru" + ("_image" if "K2e" in name else "")
                           + ("" if per_agent else "_one_stack") + "_prof")
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
