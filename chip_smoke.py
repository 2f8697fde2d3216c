#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU, and check it.

Phases, one line each:

1. the CUDA device, and its name and power limit from nvidia-smi;
2. build the kernels of ``rware_tpu_torch/csrc`` with nvcc for sm_90a;
3. the fused rollout kernel (K1) against its plain PyTorch version on the
   card, bit for bit: scripted and random mode on five configs at a batch
   that is not a multiple of 128, the main-path shape, and the plain
   version on the CPU;
4. the fused collector kernel (K2a) against its plain version on the card:
   deterministic and random mode on five configs; obs, rewards and done
   exact, value and logp within 2e-2, at least 99.9% of actions equal;
5. the main path at full size: ``make`` -> ``batched_reset`` ->
   ``build_fused_rollout`` (B=65,536, T=256, tiny-2ag) and
   ``build_fused_collect`` (B=16,384, T=128, hidden (128, 128)), timed with
   CUDA events beside the plain versions, with launch counters reset just
   before and read just after.

Then the card's name and power limit, one JSON line describing each kernel,
and as the last line ``{"ok": true, "device": {...}}``.  Any failure raises
and the script exits non-zero without that line.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

VALUE_LOGP_ATOL = 2e-2  # bf16 hidden layers; the same bound as the JAX tests
ACTION_AGREEMENT = 0.999
K1_CONFIGS = (
    "rware-tiny-2ag-v2",
    "rware-small-4ag-v2",
    "rware-medium-6ag-hard-v2",
    "rware-large-8ag-v2",
    "rware-tiny-16ag-v2",
)
# The largest per-env states (224 shelves; 16 agents with a queue of 16) spill
# to local memory in the kernels; they are covered here as well as tiny-2ag.
K2_CONFIGS = (
    ("rware-tiny-2ag-v2", {}),
    ("rware-small-4ag-v2", {"max_steps": 20}),
    ("rware-2s-tiny-2ag-v2", {"normalised_coordinates": True}),
    ("rware-large-8ag-v2", {"max_steps": 20}),
    ("rware-tiny-16ag-v2", {"max_steps": 20}),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_ms(fn, repeats: int = 1):
    """Mean milliseconds of ``fn()`` over ``repeats`` calls, by CUDA events;
    returns (ms, last result)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats, out


def state_diff(a, b) -> list:
    """Names of the state fields that differ."""
    import torch
    from rware_tpu_torch.core.state import state_field_names

    return [
        f for f in state_field_names()
        if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
    ]


def require(ok, msg: str) -> None:
    """Raise with ``msg`` unless ``ok`` (a check that ``python -O`` keeps)."""
    if not bool(ok):
        raise AssertionError(msg)


def check_invariants(env, state) -> None:
    """Agents in the grid on distinct cells; queues distinct and in range;
    carried shelves under their carriers."""
    import torch

    h, w = env.grid_size
    cells = state.agent_y.long() * w + state.agent_x.long()
    require(((state.agent_x >= 0) & (state.agent_x < w)).all(), "agent x out of grid")
    require(((state.agent_y >= 0) & (state.agent_y < h)).all(), "agent y out of grid")
    require((cells.sort(dim=1).values.diff(dim=1) > 0).all(), "two agents share a cell")
    q = state.request_queue.long()
    if q.shape[1]:
        require(((q >= 0) & (q < env.layout.n_shelves)).all(), "queue out of range")
        require((q.sort(dim=1).values.diff(dim=1) > 0).all(), "queue not distinct")
    carried = state.agent_carrying.long()
    idx = carried.clamp(min=0)
    ok = (carried < 0) | (
        (torch.gather(state.shelf_x, 1, idx) == state.agent_x)
        & (torch.gather(state.shelf_y, 1, idx) == state.agent_y)
    )
    require(ok.all(), "carried shelf not under its carrier")


def compare_k1(env_id, dev, b, t, scripted, seed, **overrides):
    """K1 kernel vs its plain version on the card; returns max |reward diff|."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.ops.fused_rollout import build_fused_rollout
    from rware_tpu_torch.parallel import batched_reset

    env = rware_tpu_torch.make(env_id, device=dev, **overrides)
    states, _ = batched_reset(env, seed, b)
    roll = build_fused_rollout(env.config, t, scripted=scripted)
    actions = None
    if scripted:
        gen = torch.Generator(device=dev).manual_seed(seed)
        actions = torch.randint(0, 5, (t, b, env.n_agents), generator=gen, device=dev,
                                dtype=torch.int32)
    ks, kr, ke = roll(states, seed + 1, actions)
    ps, pr, pe = roll.plain(states, seed + 1, actions)
    torch.cuda.synchronize()
    bad = state_diff(ks, ps)
    if bad or not torch.equal(kr, pr) or not torch.equal(ke, pe):
        raise AssertionError(
            f"K1 {env_id} scripted={scripted}: kernel != plain (fields {bad}, "
            f"rewards equal {torch.equal(kr, pr)}, episodes equal {torch.equal(ke, pe)})"
        )
    check_invariants(env, ks)
    return env, ks, kr, ke, float((kr - pr).abs().max())


def compare_k2(env_id, dev, b, t, deterministic, seed, policy=None, **overrides):
    """K2a kernel vs its plain version on the card; returns the stats."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models import ActorCritic
    from rware_tpu_torch.ops.fused_rollout import build_fused_collect
    from rware_tpu_torch.parallel import batched_reset

    env = rware_tpu_torch.make(env_id, device=dev, **overrides)
    states, _ = batched_reset(env, seed, b)
    if policy is None:
        torch.manual_seed(seed)
        policy = ActorCritic(env.config.flattened_obs_length).to(dev)
    collect = build_fused_collect(env.config, t, deterministic=deterministic)
    ks, ktraj = collect(states, policy, seed + 1)
    ps, ptraj = collect.plain(states, policy, seed + 1)
    torch.cuda.synchronize()
    for k in ("obs", "reward", "done"):
        if not torch.equal(ktraj[k], ptraj[k]):
            raise AssertionError(f"K2a {env_id} deterministic={deterministic}: {k} differs")
    bad = state_diff(ks, ps)
    if bad:
        raise AssertionError(f"K2a {env_id}: final state differs in {bad}")
    agree = float((ktraj["action"] == ptraj["action"]).float().mean())
    err = max(
        float((ktraj[k] - ptraj[k]).abs().max()) for k in ("value", "logp")
    )
    if agree < ACTION_AGREEMENT or err > VALUE_LOGP_ATOL:
        raise AssertionError(f"K2a {env_id}: action agreement {agree}, value/logp err {err}")
    for k, v in ktraj.items():
        if v.is_floating_point() and not bool(torch.isfinite(v.float()).all()):
            raise AssertionError(f"K2a {env_id}: non-finite {k}")
    check_invariants(env, ks)
    return env, ks, ktraj, agree, err


def main() -> int:
    import torch

    # ---- phase 1: device --------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU")
    import rware_tpu_torch
    from rware_tpu_torch.models import ActorCritic
    from rware_tpu_torch.ops._build import load_library
    from rware_tpu_torch.ops.fused_rollout import build_fused_collect, build_fused_rollout
    from rware_tpu_torch.parallel import batched_reset

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    # ---- phase 2: build ---------------------------------------------------------
    start = time.perf_counter()
    lib = load_library()
    ptxas = [l.strip() for l in lib.build_log.splitlines() if "registers" in l or "spill" in l]
    log(f"phase 2 build: nvcc sm_90a {lib.build_seconds:.1f} s (load {time.perf_counter() - start:.1f} s); "
        + " ; ".join(ptxas))

    # ---- phase 3: K1 vs plain ---------------------------------------------------
    for env_id in K1_CONFIGS:
        for scripted in (True, False):
            env, ks, kr, ke, _ = compare_k1(env_id, dev, 1000, 64, scripted, 7, max_steps=50)
            log(f"phase 3 K1 {env_id} B=1000 T=64 scripted={scripted}: bit-exact "
                f"(reward sum {float(kr.sum())}, episodes {int(ke.sum())})")
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=dev)
    states, _ = batched_reset(env, 3, 256)
    roll = build_fused_rollout(env.config, 32)
    ks, kr, ke = roll(states, 5)
    cpu_s, cpu_r, cpu_e = roll.plain(states.map(lambda x: x.cpu()), 5)
    if state_diff(ks, cpu_s) or not torch.equal(kr.cpu(), cpu_r) or not torch.equal(ke.cpu(), cpu_e):
        raise AssertionError("K1 kernel on the card != plain version on the CPU")
    _, ks, kr, ke, k1_err = compare_k1("rware-tiny-2ag-v2", dev, 65536, 256, False, 11)
    log(f"phase 3 K1 main shape B=65536 T=256 random: bit-exact, max_abs_err {k1_err} "
        f"(reward sum {float(kr.sum())}, episodes {int(ke.sum())}); card == CPU plain at B=256")

    # ---- phase 4: K2a vs plain --------------------------------------------------
    for env_id, overrides in K2_CONFIGS:
        for deterministic in (True, False):
            _, _, traj, agree, err = compare_k2(env_id, dev, 1000, 32, deterministic, 5, **overrides)
            log(f"phase 4 K2a {env_id} {overrides} B=1000 T=32 deterministic={deterministic}: "
                f"obs/reward/done exact, actions {agree:.6f}, value/logp err {err}")
    _, _, traj, agree, k2_err = compare_k2("rware-tiny-2ag-v2", dev, 16384, 128, False, 13)
    log(f"phase 4 K2a main shape B=16384 T=128 random: obs/reward/done exact, "
        f"actions {agree:.6f}, value/logp max_abs_err {k2_err}")

    # ---- phase 5: the main path at full size ------------------------------------
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=dev)
    b1, t1 = 65536, 256
    states, obs = batched_reset(env, 0, b1)
    rollout = build_fused_rollout(env.config, t1)
    rollout(states, 1)  # warm-up (first launch loads the module)
    b2, t2 = 16384, 128
    states2, _ = batched_reset(env, 2, b2)
    torch.manual_seed(0)
    policy = ActorCritic(env.config.flattened_obs_length, hidden=(128, 128)).to(dev)
    collect = build_fused_collect(env.config, t2, hidden=(128, 128))
    collect(states2, policy, 3)  # warm-up
    torch.cuda.synchronize()

    # Chained launches, as a user steps on: 4 x 256 steps cross the 500-step
    # episode limit.
    rollout.launches = 0
    collect.launches = 0
    chain = [(states, None, None)]
    k1_ms, _ = cuda_ms(lambda: chain.append(rollout(chain[-1][0], 4 + len(chain))), repeats=4)
    k2_ms, (fs2, traj) = cuda_ms(lambda: collect(states2, policy, 5), repeats=3)
    launches = {"fused_rollout": rollout.launches, "fused_collect": collect.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"main path launched no kernel: {launches}")
    k1_plain_ms, _ = cuda_ms(lambda: rollout.plain(states, 4))
    k2_plain_ms, _ = cuda_ms(lambda: collect.plain(states2, policy, 5))

    fs = chain[-1][0]
    rew = torch.stack([c[1] for c in chain[1:]]).sum(0)
    epis = torch.stack([c[2] for c in chain[1:]]).sum(0)
    if tuple(rew.shape) != (b1, 2) or not bool(torch.isfinite(rew).all()):
        raise AssertionError("fused rollout rewards: wrong shape or non-finite")
    if float(rew.sum()) <= 0 or int(epis.min()) < 2:
        raise AssertionError("fused rollout: no delivery, or an env ended < 2 episodes in 1024 steps")
    check_invariants(env, fs)
    want = {"obs": (t2, b2, 2, env.config.flattened_obs_length), "action": (t2, b2, 2),
            "logp": (t2, b2, 2), "value": (t2, b2, 2), "reward": (t2, b2, 2), "done": (t2, b2)}
    for k, shape in want.items():
        if tuple(traj[k].shape) != shape:
            raise AssertionError(f"fused collect {k}: shape {tuple(traj[k].shape)} != {shape}")
        if traj[k].is_floating_point() and not bool(torch.isfinite(traj[k].float()).all()):
            raise AssertionError(f"fused collect {k}: non-finite")
    if float(traj["reward"].min()) < 0 or float(traj["reward"].sum()) <= 0:
        raise AssertionError("fused collect: a negative reward, or no delivery at all")
    check_invariants(env, fs2)
    log(f"phase 5 main path K1 tiny-2ag B={b1} T={t1}: {k1_ms:.3f} ms/launch = "
        f"{b1 * t1 / k1_ms * 1e3:.4g} env-steps/s (plain {k1_plain_ms:.1f} ms), "
        f"reward checksum {float(rew.sum())}, episodes {int(epis.sum())} [{kind}, {card}]")
    log(f"phase 5 main path K2a tiny-2ag B={b2} T={t2} hidden (128, 128): {k2_ms:.3f} ms/launch = "
        f"{b2 * t2 / k2_ms * 1e3:.4g} env-steps/s (plain {k2_plain_ms:.1f} ms), "
        f"reward checksum {float(traj['reward'].sum())}, launches {launches} [{kind}, {card}]")

    kernels = [
        {"name": "fused_rollout", "route": "cuda",
         "source": "rware_tpu_torch/csrc/fused_rollout.cu",
         "replaces": "rware_tpu/ops/pallas_rollout.py:657",
         "launches": launches["fused_rollout"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "fused_collect", "route": "cuda",
         "source": "rware_tpu_torch/csrc/fused_collect.cu",
         "replaces": "rware_tpu/ops/pallas_rollout.py:1798",
         "launches": launches["fused_collect"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
