#!/usr/bin/env python3
"""Where the PPO per-sample kernel spends its time, phase by phase, on a CUDA GPU.

Copies this checkout's ``rware_tpu_torch`` into ``--work-dir``, adds
``clock64()`` counters between the phases of ``ppo_sample_kernel``
(``csrc/ppo_sample.cuh``): the obs chunks and ``x W0``; h1 out and ``h1 W1``;
the f32 head's forward; the loss pieces; the head's weight gradient; dh2 and
dz2; ``dz2 W1^T`` and dz1 out.  Thread 0 of each block reads the clock after
each phase's barrier, so a phase's cycles are the block's wall cycles in it,
the other block on the SM included.  The copy is built and K4 is launched on
one 32-row window of tiny-2ag at B=16,384 (hidden (128, 128), random data);
the script prints the share of each phase and the cycles a tile takes a
block, with K4's time (CUDA events) and the card's name and power limit.  The
counters change the kernel's timing a little; the checkout itself is not
touched.

Usage: python tools/ppo_phase_profile.py [--work-dir DIR] [--repeats N]
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ["obs chunks + x W0", "h1 out + h1 W1", "head forward", "loss pieces",
          "head weight gradient", "dh2, dz2", "dz2 W1^T, dz1 out"]
# (text the counter follows, counter): each anchor ends a phase of the tile loop
ANCHORS = [
    ("    tanh_out(acc, sb0, NT1, ld1);\n    __syncthreads();\n", 0),
    ("    tanh_out(acc, sb1, NT2, ld2);\n    __syncthreads();\n", 1),
    ("      if (kMode == PPO_VALUES && a < AC && xrow[s] >= 0) ws.values[xrow[s] * AC + a] = v;\n"
     "    }\n    __syncthreads();\n", 2),
    ("      for (int a = 0; a < HCP; ++a) dbcs[s * HCP + a] += hrow[a];  // dbc, this slot's share\n"
     "    }\n    __syncthreads();\n", 3),
]


def patch(work: str) -> None:
    """Add the phase counters to the copy's per-sample kernel and an accessor
    to its library."""
    p = os.path.join(work, "rware_tpu_torch", "csrc", "ppo_sample.cuh")
    s = open(p).read()
    s = s.replace("template <int kMode>\n__global__",
                  "__device__ unsigned long long g_ppo_prof[8];\n\ntemplate <int kMode>\n__global__", 1)
    head = "  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {\n"
    s = s.replace(head, (
        "  unsigned long long prof[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
        "  long long t_prev = clock64();\n"
        "#define PPO_MARK(i) do { if (tid == 0) { const long long t_ = clock64(); "
        "prof[i] += t_ - t_prev; t_prev = t_; } } while (0)\n") + head, 1)
    for text, i in ANCHORS:
        if text not in s:
            raise SystemExit(f"phase anchor {i} not found in ppo_sample.cuh")
        s = s.replace(text, text + f"    PPO_MARK({i});\n", 1)
    for text, i in (("    // ---- dz2 = bf16(bf16(dcat Wc^T)", 4),
                    ("    // ---- dz1 = bf16(bf16(dz2 W1^T)", 5)):
        if text not in s:
            raise SystemExit(f"phase anchor {i} not found in ppo_sample.cuh")
        s = s.replace(text, f"    PPO_MARK({i});\n" + text, 1)
    tail = "    store_rows(ws.dz1, H1s, ld1, s0);\n    __syncthreads();\n  }\n"
    if tail not in s:
        raise SystemExit("the tile loop's end not found in ppo_sample.cuh")
    s = s.replace(tail, tail[:-4] + "    PPO_MARK(6);\n  }\n"
                  "  if (tid == 0) for (int i = 0; i < 8; ++i) atomicAdd(&g_ppo_prof[i], prof[i]);\n", 1)
    open(p, "w").write(s)
    p = os.path.join(work, "rware_tpu_torch", "csrc", "fused_ppo_grads.cu")
    with open(p, "a") as f:
        f.write("\nextern \"C\" int rw_ppo_prof(unsigned long long* out) {\n"
                "  cudaError_t e = cudaMemcpyFromSymbol(out, g_ppo_prof, 8 * sizeof(unsigned long long));\n"
                "  unsigned long long z[8] = {0};\n"
                "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_ppo_prof, z, sizeof(z));\n"
                "  return (int)e;\n}\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--work-dir", default=os.path.join(ROOT, "build", "ppo_phase_profile"))
    ap.add_argument("--repeats", type=int, default=5)
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
    from rware_tpu_torch.ops._build import load_library
    from rware_tpu_torch.ops.fused_update import build_fused_ppo_grads
    from rware_tpu_torch.testing import random_ppo_case

    dev = torch.device("cuda:0")
    lib = load_library()
    lib.rw_ppo_prof.argtypes = [ctypes.c_void_p]
    counts = (ctypes.c_ulonglong * 8)()
    b, t_mb = 16384, 32
    dims, params, data = random_ppo_case("rware-tiny-2ag-v2", b, 4 * t_mb, 3, dev)
    k4 = build_fused_ppo_grads(dims, t_mb, clip_eps=0.2, vf_coef=0.5, ent_coef=0.01)
    k4(params, data, 5)
    torch.cuda.synchronize()
    lib.rw_ppo_prof(ctypes.addressof(counts))  # zero the counters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.repeats):
        k4(params, data, 5)
    end.record()
    torch.cuda.synchronize()
    if lib.rw_ppo_prof(ctypes.addressof(counts)) != 0:
        raise SystemExit("reading the counters failed")
    total = float(sum(counts[:len(PHASES)]))
    n_tiles = -(-t_mb * b * data[1].shape[2] // 64)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "kernel": "ppo_sample_kernel (K4, PPO_ACTOR)", "env": "rware-tiny-2ag-v2", "B": b,
        "T_mb": t_mb, "k4_ms": start.elapsed_time(end) / args.repeats,
        "cycles_a_tile_a_block": total / args.repeats / n_tiles,
        "phase_share": {name: counts[i] / total for i, name in enumerate(PHASES)},
        "device": card}))


if __name__ == "__main__":
    main()
