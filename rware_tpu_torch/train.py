"""Train IPPO with the shared MLP policy on a warehouse config — the port's
counterpart of ``train.py`` (algo ``ippo``, net ``mlp``).

Examples::

    python -m rware_tpu_torch.train --device cuda --env rware-tiny-2ag-v2 \\
        --n-envs 4096 --updates 300 --checkpoint-dir ckpts/run1
    python -m rware_tpu_torch.train --device cpu --n-envs 128 --rollout-len 8 --updates 2

``--collect fused`` (default) trains through the fused collector (K2a) and
the whole-update-phase kernel (K3) on a GPU, and through their plain
versions on the CPU; ``--collect plain`` runs the plain learner
(``models/ippo.build_train_step``).  The device is never chosen for you:
``--device cuda`` without a GPU raises.  The final policy is written with
``torch.save`` to ``<checkpoint-dir>/policy.pt``.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

NOT_PORTED = "not ported yet: the port trains --algo ippo --net mlp"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--env", default="rware-tiny-2ag-v2")
    p.add_argument("--algo", choices=["ippo", "mappo", "seac", "seac-ppo"], default="ippo")
    p.add_argument("--net", choices=["mlp", "gru"], default="mlp")
    p.add_argument("--collect", choices=["fused", "plain"], default="fused",
                   help="fused = K2a collector + K3 update phase; plain = the plain learner")
    p.add_argument("--minibatch-mode", choices=["shuffle", "block"], default="shuffle",
                   help="minibatches of the plain learner (the fused path takes time windows)")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    p.add_argument("--updates", type=int, default=100)
    p.add_argument("--n-envs", type=int, default=256)
    p.add_argument("--rollout-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint-dir", default=None)
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """The requested device; a CUDA device must exist."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return dev


def save_policy(path: str, env_id: str, dims, params: torch.Tensor, updates: int) -> None:
    """``torch.save`` of the policy: its ``ActorCritic`` state dict and sizes."""
    from rware_tpu_torch.models.ippo import policy_of

    model = policy_of(dims, params.cpu())
    torch.save({"env": env_id, "obs_dim": dims.obs_len, "n_actions": dims.n_actions,
                "hidden": (dims.h1, dims.h2), "updates": updates,
                "state_dict": model.state_dict()}, path)


def load_policy(path: str, device="cpu"):
    """(env id, ActorCritic) of a file written by :func:`save_policy`."""
    from rware_tpu_torch.models.networks import ActorCritic

    ckpt = torch.load(path, map_location="cpu")
    model = ActorCritic(ckpt["obs_dim"], ckpt["n_actions"], tuple(ckpt["hidden"]))
    model.load_state_dict(ckpt["state_dict"])
    return ckpt["env"], model.to(device)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.algo != "ippo" or args.net != "mlp":
        raise NotImplementedError(f"--algo {args.algo} --net {args.net}: {NOT_PORTED}")
    dev = resolve_device(args.device)

    import rware_tpu_torch
    from rware_tpu_torch.models.ippo import IPPOConfig, build_train_step, init_runner
    from rware_tpu_torch.models.ippo_fused import build_fused_train_step

    env = rware_tpu_torch.make(args.env, device=dev)
    cfg = IPPOConfig(n_envs=args.n_envs, rollout_len=args.rollout_len, lr=args.lr,
                     ent_coef=args.ent_coef, minibatch_mode=args.minibatch_mode)
    runner, dims = init_runner(env, cfg, args.seed)
    if args.collect == "fused":
        train_step = build_fused_train_step(env, dims, cfg)
    else:
        train_step = build_train_step(env, dims, cfg)
    env_steps_per_update = cfg.n_envs * cfg.rollout_len
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"training {args.env} on {dev} ({card}): {args.updates} updates x "
          f"{env_steps_per_update} env-steps, collect {args.collect}", flush=True)
    log_every = max(1, args.log_every)
    t0 = last_t = time.perf_counter()
    last_u, step_ms, entry = 0, [], {}
    for u in range(args.updates):
        runner, metrics = train_step(runner)
        if (u + 1) % log_every and u + 1 != args.updates:
            continue
        entry = {k: float(v) for k, v in metrics.items()}  # syncs the device
        now = time.perf_counter()
        n = u + 1 - last_u
        if last_u > 0:  # the first window holds the set-up (kernel build, warm-up)
            step_ms.append((now - last_t) * 1e3 / n)
        entry.update(wall_s=now - t0, env_steps_per_s=env_steps_per_update * n / (now - last_t))
        print("  ".join([f"step {u + 1}"] + [f"{k}={v:.4g}" for k, v in entry.items()]),
              flush=True)
        last_u, last_t = u + 1, now
    if step_ms:
        ms = sorted(step_ms)[len(step_ms) // 2]
        print(f"timing: {ms:.1f}ms p50 per update "
              f"({env_steps_per_update / ms * 1e3 / 1e6:.2f}M env-steps/s)", flush=True)
    if args.checkpoint_dir:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        path = os.path.join(args.checkpoint_dir, "policy.pt")
        save_policy(path, args.env, dims, runner.params, args.updates)
        print(f"saved {path}", flush=True)
    print("done:", {k: round(v, 4) for k, v in entry.items()
                    if "loss" in k or "reward" in k or "env_steps" in k}, flush=True)
    return entry


if __name__ == "__main__":
    main()
