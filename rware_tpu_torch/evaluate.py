"""Evaluate a policy saved by ``rware_tpu_torch.train`` — the port's
counterpart of ``evaluate.py`` for the nets the port trains: the shared MLP
(``ActorCritic``; IPPO's, and MAPPO's actor), the shared GRU
(``RecurrentActorCritic``; recurrent IPPO's), one MLP per agent (an
``nn.ModuleList`` of ``ActorCritic``; SEAC-PPO's) and one GRU per agent (an
``nn.ModuleList`` of ``RecurrentActorCritic``; recurrent SEAC-PPO's).  The
checkpoint names its kind and its message bits; a policy with message bits
plays an env with as many, through the collectors' message mode (K2b).

Examples::

    python -m rware_tpu_torch.evaluate --device cuda --checkpoint-dir ckpts/run1 --episodes 256
    python -m rware_tpu_torch.evaluate --device cpu --env rware-tiny-2ag-v2 --random

One episode per env: the env runs ``--max-steps`` steps of the sampled
policy through the fused collector of its kind (the K2a, K2c, K2d or K2d′
kernel on a GPU, its plain version on the CPU; ``evaluate.py:71-132`` for
the per-agent stacks), and an env's return is its reward summed
over agents until its first episode end (``evaluate.py:176-214``).  A GRU
policy starts from the zero carry, which the collector threads through the
steps and zeroes at episode ends (``evaluate.py:119-192``).
"""
from __future__ import annotations

import argparse
import os

import torch
from torch import nn

from rware_tpu_torch.models.networks import ActorCritic, RecurrentActorCritic


def mean_return(env, policy, episodes: int, max_steps: int = 500, seed: int = 0) -> dict:
    """Return statistics of ``episodes`` envs, each run for ``max_steps``
    steps of ``policy`` (an ``ActorCritic``, a ``RecurrentActorCritic`` or an
    ``nn.ModuleList`` of one of them per agent) from a fresh reset: mean and
    std of the returns, the mean episode length and the number of envs whose
    episode had not ended."""
    from rware_tpu_torch.ops.fused_rollout import (
        build_fused_collect,
        build_fused_collect_gru,
        build_fused_collect_gru_per_agent,
        build_fused_collect_per_agent,
    )
    from rware_tpu_torch.parallel import batched_reset

    states, _ = batched_reset(env, seed, episodes)
    policy = policy.to(env.device)
    net = policy[0] if isinstance(policy, nn.ModuleList) else policy
    if isinstance(net, RecurrentActorCritic):
        build = build_fused_collect_gru_per_agent if net is not policy else build_fused_collect_gru
        collect = build(env.config, max_steps, (net.embed_dim, net.hidden))
        carry = net.initialize_carry((episodes, env.n_agents), env.device)
        _, _, traj = collect(states, policy, seed, carry)
    elif net is not policy:
        collect = build_fused_collect_per_agent(env.config, max_steps, net.hidden)
        _, traj = collect(states, policy, seed)
    else:
        collect = build_fused_collect(env.config, max_steps, policy.hidden)
        _, traj = collect(states, policy, seed)
    done = traj["done"].to(torch.float32)  # (T, B)
    alive = torch.cumprod(torch.cat([torch.ones_like(done[:1]), 1.0 - done[:-1]]), dim=0)
    returns = (traj["reward"].sum(-1) * alive).sum(0)
    return {
        "episodes": episodes,
        "mean_return": float(returns.mean()),
        "std": float(returns.std(correction=0)),
        "mean_length": float(alive.sum(0).mean()),
        "unfinished": int((alive[-1] * (1.0 - done[-1])).sum()),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--env", default=None, help="default: the checkpoint's env")
    p.add_argument("--episodes", type=int, default=128)
    p.add_argument("--max-steps", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--random", action="store_true", help="uniform random policy baseline")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import rware_tpu_torch
    from rware_tpu_torch.train import load_policy, resolve_device

    dev = resolve_device(args.device)
    if args.random:
        env_id = args.env or "rware-tiny-2ag-v2"
        length = rware_tpu_torch.parse_env_id(env_id).policy_obs_length
        policy = ActorCritic(length)
        with torch.no_grad():
            for p in policy.parameters():
                p.zero_()  # zero logits: Gumbel-argmax samples uniformly
    else:
        if not args.checkpoint_dir:
            raise SystemExit("--checkpoint-dir required unless --random")
        env_id, policy = load_policy(os.path.join(args.checkpoint_dir, "policy.pt"))
        env_id = args.env or env_id
    msg_bits = (policy[0] if isinstance(policy, nn.ModuleList) else policy).msg_bits
    env = rware_tpu_torch.make(env_id, device=dev, msg_bits=msg_bits)
    stats = mean_return(env, policy, args.episodes, args.max_steps, args.seed)
    print(f"episodes={stats['episodes']} mean_return={stats['mean_return']:.3f} "
          f"std={stats['std']:.3f} mean_length={stats['mean_length']:.1f} "
          f"unfinished={stats['unfinished']}", flush=True)
    return stats


if __name__ == "__main__":
    main()
