"""Builds the CUDA kernels of ``rware_tpu_torch/csrc`` and loads them.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process per
source, all started together, and links the objects into one shared library
with a plain C interface; ``ctypes`` loads it.  The library lands in
``build/rware_tpu_torch/`` beside the package, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one is
reused.  Nothing here runs at import: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rware_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# n s r g h w reward max_steps max_inactive msg_bits, seed, env_offset
_DIMS = [_I] * 10 + [ctypes.c_ulonglong, ctypes.c_uint]
# L H1 H2 A T_full T_mb B N | clip_eps vf_coef ent_coef inv_n |
# tile grid smem w0_smem chunk n_chunks wgrad_smem (fused_update.PpoPlan.args)
_PPO_DIMS = [_I] * 8 + [_F] * 4 + [_I] * 7
# ... | c_tile c_grid c_smem c_w0_smem c_chunk c_n_chunks c_wgrad_smem CH1 CH2 (the critic's)
_MAPPO_DIMS = _PPO_DIMS + [_I] * 9
_SIGNATURES = {
    # ... scripted T B | plan (host int array, fused_rollout.RolloutPlan.args)
    # n_plan | layout state_in state_out actions rewards episodes scratch stream
    "rw_fused_rollout": _DIMS + [_I] * 3 + [_P, _I] + [_P] * 8,
    # ... deterministic T B sensor_range normalised img_layers img_n_layers
    # img_directional img_self L H1 H2 A n_stacks | plan (host int array,
    # fused_rollout.CollectPlan.args) n_plan | layout state_in state_out w0 b0
    # w1 b1 wp bp wv bv wm bm obs action bits logp value reward done stream
    "rw_fused_collect": _DIMS + [_I] * 14 + [_P, _I] + [_P] * 21,
    # ... deterministic T B sensor_range normalised img_layers img_n_layers
    # img_directional img_self L E Hg A n_stacks | plan (host int array,
    # fused_rollout.GruCollectPlan.args) n_plan | layout state_in state_out we
    # be wi bi wh bhn wc bc h0 new_h obs action bits logp value reward done
    # stream
    "rw_fused_collect_gru": _DIMS + [_I] * 14 + [_P, _I] + [_P] * 21,
    # L E Hg T B N start_env n_env rows smem (fused_gru.gru_obs_fwd_plan) | obs
    # done h0 we be wi bi wh bhn hseq stream
    "rw_fused_gru_fwd": [_I] * 10 + [_P] * 11,
    # L E Hg T B N start_env n_env sweep_rows prologue_smem sweep_smem
    # epilogue_smem wgrad_smem chunk n_chunks | obs done h0 hseq dhseq we be wi bi
    # wh bhn, scratch e rz hn dg4 dpre part_bhn partial, grads dh0 split_ms stream
    "rw_fused_gru_bwd": [_I] * 15 + [_P] * 22,
    # Hg T B N start_env n_env rows smem (fused_gru.gru_seq_fwd_plan) | iall done
    # h0 wh bhn hseq stream
    "rw_fused_gru_seq_fwd": [_I] * 8 + [_P] * 7,
    # Hg T B N start_env n_env | plan (fused_gru.GruSeqBwdPlan.args) | iall done
    # h0 hseq dhseq wh bhn, scratch rz hn dhhn part_bhn partial, d_iall grads
    # dh0 split_ms stream
    "rw_fused_gru_seq_bwd": [_I] * 13 + [_P] * 17,
    # Hg A T B N start_env n_env | plan | clip_eps vf_coef ent_coef inv_n | stats
    # iall done h0 hseq action logp value adv target wh bhn head, scratch rz hn
    # dhhn dheads part_bhn part_head partial, d_iall grads dh0 split_ms stream
    "rw_fused_gru_loss_bwd": [_I] * 14 + [_F] * 4 + [_P] * 25,
    # ... msg_bits hc | start stats obs action logp value adv target bits params h1
    # h2 dz1 dz2 part_head partial part_mets grads mets stream
    "rw_fused_ppo_grads": _PPO_DIMS + [_I] * 2 + [_P] * 20,
    # ... seac_lambda | start stats obs action logp value adv target params h1
    # h2 dz1 dz2 part_head partial part_mets grads mets stream
    "rw_fused_seac_grads": _PPO_DIMS + [_F] + [_P] * 19,
    # ... max_grad_norm n_passes | starts advstats hyper obs action logp value
    # adv target params mu nu h1 h2 dz1 dz2 part_head partial part_mets grads
    # mets split_ms stream
    "rw_fused_ppo_update_phase": _PPO_DIMS + [_F, _I] + [_P] * 23,
    # K0 CH1 CH2 agents T B tile grid smem w0_smem | obs cparams values stream
    "rw_fused_critic_values": [_I] * 10 + [_P] * 4,
    # ... with_actor | start stats obs action logp value adv target aparams
    # cparams, the actor's then the critic's h1 h2 dz1 dz2 part_head partial
    # part_mets, agrads cgrads mets stream
    "rw_fused_mappo_grads": _MAPPO_DIMS + [_I] + [_P] * 28,
    # ... max_grad_norm n_passes | starts advstats hyper obs action logp value
    # adv target aparams amu anu cparams cmu cnu, the two workspaces, agrads
    # cgrads mets stream
    "rw_fused_mappo_update_phase": _MAPPO_DIMS + [_F, _I] + [_P] * 33,
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library.

    The returned handle carries ``build_log`` (the compiler's report,
    including ``ptxas`` register and spill counts) and ``build_seconds``
    (0 when an existing build was reused)."""
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cuh + cu:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    tag = digest.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"librware_kernels-{tag}.so"
    log_path = BUILD_DIR / f"nvcc-{tag}.log"
    seconds = 0.0
    if not lib_path.exists():
        start = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, f"{src.stem}.o") for src in cu]
            cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                    for src, obj in zip(cu, objs)]
            link = [_nvcc(), "-shared", "-o", os.path.join(tmp, "lib.so"), *objs]
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for c in cmds]
            outs = [proc.communicate()[0] for proc in procs]
            log = [" ".join(cmd) + "\n" + out for cmd, out in zip(cmds, outs)]
            for proc, out in zip(procs, outs):
                if proc.returncode != 0:
                    log_path.write_text("\n".join(log))
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{out[-4000:]}")
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            log_path.write_text("\n".join(log))
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
            os.replace(os.path.join(tmp, "lib.so"), lib_path)
        seconds = time.perf_counter() - start
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rw_error_string.argtypes = [ctypes.c_int]
    lib.rw_error_string.restype = ctypes.c_char_p
    lib.build_log = log_path.read_text() if log_path.exists() else ""
    lib.build_seconds = seconds
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.rw_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")
