#!/usr/bin/env python3
"""Where the GRU forward sweeps spend a step, phase by phase, on a CUDA GPU:
K9, the obs-fused forward (``csrc/fused_gru_fwd.cu``), or K11, the iall-fed
forward (``csrc/fused_gru_seq_fwd.cu``), which share the sweep of
``csrc/gru_fwd_sweep.cuh``.

Builds the kernel's source alone with ``nvcc`` (into ``--work-dir``), twice:
as it is, and with the phase counters (``RW_GRU_FWD_MARK*``, empty in the
checkout) defined as the SM's clock, read by thread 0 of each block after
each phase, so that a phase's cycles are the block's wall cycles in it as
warp 0 sees them.  K9's phases:

- step start: waiting for the step's obs rows, hseq of the step before out
  and its reset, the obs rows repacked into the tile (two barriers);
- embed: the We slices of the ring and e (a barrier a slice);
- input gates: the Wi slices of the ring and iall (a barrier a slice);
- h Wh and gates: the one product on the carry's path and new h.

K11's: the step start (waiting for the step's iall, hseq of the step before
out and its reset, the step's iall from the tile into registers, two
barriers), the next step's iall issued, and h Wh with the gates.

Both builds are launched at the band shape of the recurrent learners
(tiny-2ag, B=16,384, T=128, a 4,096-env band that wraps, embed 128, GRU 128)
on random inputs, held to the kernel's plain version (the share of hseq
within one bf16 step, the largest difference, two launches bit-equal) and
timed with CUDA events (the median of ``--repeats`` launches).  Prints one
JSON line a kernel: the time with and without counters, the cycles of a step
of a block, each phase's share, the registers ``ptxas`` gave each tile
height, and the card's name and power limit.  The checkout itself is not
touched.

Usage: python tools/gru_fwd_phase_profile.py [--kernels k9 k11] [--repeats N] [--work-dir DIR]
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
sys.path.insert(0, ROOT)
# kernel: (source, kernel symbol, phase names by counter)
KERNELS = {
    "k9": ("fused_gru_fwd.cu", "gru_obs_fwd_kernel",
           ["step start (obs in, hseq out, repack)", "embed", "input gates", "h Wh and gates"]),
    "k11": ("fused_gru_seq_fwd.cu", "gru_seq_fwd_kernel",
            ["step start (iall into registers, hseq out)", "next step's iall issued", None,
             "h Wh and gates"]),
}
COUNTERS = """
static __device__ __forceinline__ long long rw_clock_() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
  return t;
}
#define RW_GRU_FWD_MARK(i) { const long long t_ = rw_clock_(); \\
    if (threadIdx.x == 0) prof_[i] += t_ - prev_; prev_ = t_; }
#define RW_GRU_FWD_MARK_INIT long long prof_[4] = {0, 0, 0, 0}; long long prev_ = rw_clock_();
#define RW_GRU_FWD_MARK_END if (threadIdx.x == 0) \\
    for (int i_ = 0; i_ < 4; ++i_) atomicAdd(&g_gru_fwd_prof[i_], (unsigned long long)prof_[i_]);
static __device__ unsigned long long g_gru_fwd_prof[4];
"""
ACCESSOR = """
extern "C" int rw_gru_fwd_prof(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_gru_fwd_prof, 4 * sizeof(unsigned long long));
  unsigned long long z[4] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_gru_fwd_prof, z, sizeof(z));
  return (int)e;
}
"""


def build(work, source, name, counters):
    """(nvcc command, output path) of one build of ``source`` alone."""
    from rware_tpu_torch.ops._build import NVCC_FLAGS, _nvcc

    csrc = os.path.join(ROOT, "rware_tpu_torch", "csrc")
    src = open(os.path.join(csrc, source)).read()
    if counters:
        anchor = '#include "gru_fwd_sweep.cuh"\n'
        sweep = open(os.path.join(csrc, "gru_fwd_sweep.cuh")).read()
        if anchor not in src or "RW_GRU_FWD_MARK_INIT;" not in sweep:
            raise SystemExit(f"the phase counters' hooks not found in {source}")
        src = src.replace(anchor, COUNTERS + anchor, 1) + ACCESSOR
    path = os.path.join(work, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    out = os.path.join(work, f"lib{name}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", csrc, "-shared", "-o", out, path]
    return cmd, out


def registers(log, symbol):
    """{tile height: registers} from ptxas's report."""
    regs = {}
    for m in re.finditer(symbol + r"ILi(\d)E.*?\n.*?\n.*?Used (\d+) registers", log):
        regs[16 * int(m.group(1))] = int(m.group(2))
    return regs


def k9_case(dev, b, t_len, band):
    """K9's inputs, plain hseq and launch at the band shape."""
    import torch
    from rware_tpu_torch.models.networks import GruDims
    from rware_tpu_torch.ops.fused_gru import build_fused_gru_obs_fwd, gru_obs_fwd_plan

    n, length = 2, 71
    dims = GruDims(length, 128, 128, 5)
    gen = torch.Generator().manual_seed(17)
    weights = [(torch.randn(s, generator=gen) * (0.1 if s[0] == 1 else s[0] ** -0.5)).to(dev)
               for s in dims.shapes[:6]]
    obs = (torch.randint(0, 3, (t_len, b, n, length), generator=gen, dtype=torch.int8) * 0.5)
    obs = obs.to(torch.bfloat16).to(dev)
    done = (torch.rand((t_len, b), generator=gen) < 0.02).to(dev)
    h0 = (torch.rand((b, n, 128), generator=gen) * 2 - 1).to(torch.bfloat16).to(dev)
    want = build_fused_gru_obs_fwd(dims).plain(weights, obs, done, h0, *band)
    plan = gru_obs_fwd_plan(dims, n, band[1])
    we, be, wi, bi, wh, bhn = weights
    ins = [obs, done, h0, we.to(torch.bfloat16).contiguous(), be.float().contiguous(),
           wi.to(torch.bfloat16).contiguous(), bi.float().contiguous(),
           wh.to(torch.bfloat16).contiguous(), bhn.float().contiguous()]

    def launch(lib, hseq, stream):
        return lib.rw_fused_gru_fwd(length, 128, 128, t_len, b, n, *band, plan.rows, plan.smem,
                                    *[ctypes.c_void_p(x.data_ptr()) for x in ins], hseq, stream)
    return want, plan, launch


def k11_case(dev, b, t_len, band):
    """K11's inputs (``testing.random_gru_seq_case``), plain hseq and launch at
    the band shape."""
    import torch
    from rware_tpu_torch.ops.fused_gru import build_fused_gru_seq_fwd, gru_seq_fwd_plan
    from rware_tpu_torch.testing import random_gru_seq_case

    dims, a = random_gru_seq_case("rware-tiny-2ag-v2", b, t_len, band, 37, dev)
    seq = (a["wh"], a["bhn"], a["iall"], a["done"], a["h0"])
    want = build_fused_gru_seq_fwd(dims).plain(*seq, *band)
    n = a["h0"].shape[1]
    plan = gru_seq_fwd_plan(dims, n, band[1])
    ins = [a["iall"], a["done"], a["h0"], a["wh"].to(torch.bfloat16).contiguous(),
           a["bhn"].float().contiguous()]

    def launch(lib, hseq, stream):
        return lib.rw_fused_gru_seq_fwd(128, t_len, b, n, *band, plan.rows, plan.smem,
                                        *[ctypes.c_void_p(x.data_ptr()) for x in ins], hseq,
                                        stream)
    return want, plan, launch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", nargs="+", choices=sorted(KERNELS), default=["k9", "k11"])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--work-dir", default=os.path.join(ROOT, "build", "gru_fwd_phase_profile"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")

    work = os.path.abspath(args.work_dir)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    jobs = []
    for kernel in args.kernels:
        for counters in (False, True):
            cmd, out = build(work, KERNELS[kernel][0], kernel + ("_prof" if counters else ""),
                             counters)
            jobs.append((kernel, counters, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs, logs = {}, {}
    for kernel, counters, out, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {kernel}:\n{log[-4000:]}")
        libs[kernel, counters] = ctypes.CDLL(out)
        logs[kernel, counters] = log
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()

    dev = torch.device("cuda:0")
    b, t_len = 16384, 128
    band = ((b - 5 * 128) % b, b // 4)  # the first band of an epoch at row offset 5: it wraps
    for kernel in args.kernels:
        source, symbol, phases = KERNELS[kernel]
        want, plan, launch_fn = (k9_case if kernel == "k9" else k11_case)(dev, b, t_len, band)
        counts = (ctypes.c_ulonglong * 4)()

        def launch(lib):
            hseq = torch.empty(want.shape, dtype=torch.bfloat16, device=dev)
            code = launch_fn(lib, ctypes.c_void_p(hseq.data_ptr()),
                             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
            if code != 0:
                raise SystemExit(f"{kernel} launch failed: CUDA error {code}")
            return hseq

        def timed(lib):
            launch(lib)
            torch.cuda.synchronize()
            times = []
            for _ in range(args.repeats):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                launch(lib)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            return statistics.median(times), min(times), max(times)

        lib, prof = libs[kernel, False], libs[kernel, True]
        got, again = launch(lib), launch(lib)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        ms = timed(lib)
        prof.rw_gru_fwd_prof.argtypes = [ctypes.c_void_p]
        timed(prof)
        prof.rw_gru_fwd_prof(ctypes.addressof(counts))  # zero the counters
        ms_prof = timed(prof)
        if prof.rw_gru_fwd_prof(ctypes.addressof(counts)) != 0:
            raise SystemExit("reading the counters failed")
        total = float(sum(counts))
        steps = (args.repeats + 1) * plan.blocks * t_len
        print(json.dumps({
            "kernel": f"{kernel} ({source})", "B": b, "T": t_len, "band": band,
            "rows": plan.rows, "blocks": plan.blocks, "smem": plan.smem,
            "ms_median_min_max": ms, "ms_with_counters": ms_prof,
            "hseq_within_a_bf16_step": float((diff <= 2.0 ** -7).float().mean()),
            "hseq_max_abs_err": float(diff.max()), "bit_equal_relaunch": torch.equal(got, again),
            "cycles_a_step_a_block": total / steps,
            "phase_share": {p: counts[i] / total for i, p in enumerate(phases) if p},
            "registers": registers(logs[kernel, False], symbol),
            "ptxas": [ln.strip() for ln in logs[kernel, False].splitlines()
                      if "spill" in ln or "Used" in ln or "entry function" in ln],
            "device": card}), flush=True)
        del want, got, again
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
