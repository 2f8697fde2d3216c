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
    python -m rware_tpu_torch.evaluate --device cuda --checkpoint-dir ckpts/run1 --greedy
    python -m rware_tpu_torch.evaluate --device cuda --checkpoint-dir ckpts/run1 \
        --render-frames out/   # 60 PNG frames of env 0

One episode per env: the env runs ``--max-steps`` steps of the sampled
policy through the fused collector of its kind (the K2a, K2c, K2d or K2d′
kernel on a GPU, its plain version on the CPU; ``evaluate.py:71-132`` for
the per-agent stacks), and an env's return is its reward summed
over agents until its first episode end (``evaluate.py:176-214``).  A GRU
policy starts from the zero carry, which the collector threads through the
steps and zeroes at episode ends (``evaluate.py:119-192``).

``--greedy`` plays the argmax move, and sets a message bit where its logit is
> 0 (``evaluate.py:142-156``): a loop of the engine's step and the net's
forward on the device (JAX's greedy evaluation is XLA ops too), with the
queue draws from a generator; the collectors' deterministic mode would also
script the respawns and queue draws.  ``--render-frames DIR`` writes 60
frames of env 0 under the policy (``evaluate.py:217-245``): PNGs through PIL
where it is installed, else ``.npy`` arrays.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
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


def greedy_actions(logits) -> torch.Tensor:
    """JAX's greedy rule: the argmax move (..., ) int32, or with message bits
    ``(logits, msg_logits)`` the move and the bits ``msg_logits > 0``
    (..., 1 + M)."""
    if isinstance(logits, tuple):
        move, msg = logits
        return torch.cat([move.argmax(-1, keepdim=True), (msg > 0).long()], dim=-1).to(torch.int32)
    return logits.argmax(-1).to(torch.int32)


def policy_logits(policy, obs: torch.Tensor, carry=None):
    """``(logits, carry)`` of ``policy`` on obs (B, N, L): a shared net, or an
    ``nn.ModuleList`` with agent i's net on agent i's obs (and carry); a GRU
    takes the carry (B, N, hidden) and returns the new one."""
    net = policy[0] if isinstance(policy, nn.ModuleList) else policy
    recurrent = isinstance(net, RecurrentActorCritic)
    if net is policy:
        if recurrent:
            carry, (logits, _) = policy(carry, obs)
        else:
            logits, _ = policy(obs)
        return logits, carry
    heads, carries = [], []
    for i, agent in enumerate(policy):
        if recurrent:
            c, (logits, _) = agent(carry[:, i], obs[:, i])
            carries.append(c)
        else:
            logits, _ = agent(obs[:, i])
        heads.append(logits)
    if isinstance(heads[0], tuple):
        logits = tuple(torch.stack(h, dim=1) for h in zip(*heads))
    else:
        logits = torch.stack(heads, dim=1)
    return logits, (torch.stack(carries, dim=1) if recurrent else carry)


def _initial_carry(policy, b: int, n: int, device):
    net = policy[0] if isinstance(policy, nn.ModuleList) else policy
    if isinstance(net, RecurrentActorCritic):
        return net.initialize_carry((b, n), device)
    return None


@torch.no_grad()
def greedy_return(env, policy, episodes: int, max_steps: int = 500, seed: int = 0) -> dict:
    """``mean_return``'s statistics under the greedy rule, by a loop of
    ``env.step`` and the policy's forward (``evaluate.py:159-206``): each env
    runs ``max_steps`` steps from a fresh reset; its return is summed until
    its first episode end, and a GRU's carry is zeroed where an episode
    ends."""
    from rware_tpu_torch.models.ippo import policy_obs_fn
    from rware_tpu_torch.parallel import batched_reset

    states, _ = batched_reset(env, seed, episodes)
    policy = policy.to(env.device)
    observe = policy_obs_fn(env)
    gen = torch.Generator(device=env.device).manual_seed(seed + 1)
    carry = _initial_carry(policy, episodes, env.n_agents, env.device)
    returns = torch.zeros(episodes, device=env.device)
    lengths = torch.zeros(episodes, device=env.device)
    alive = torch.ones(episodes, device=env.device)
    for _ in range(max_steps):
        logits, carry = policy_logits(policy, observe(states), carry)
        res = env.step(states, greedy_actions(logits), gen)
        returns += res.rewards.sum(-1) * alive
        lengths += alive
        alive = alive * (1.0 - res.done.to(torch.float32))
        if carry is not None:
            carry = torch.where(res.done[:, None, None], torch.zeros_like(carry), carry)
        states = res.state
    return {
        "episodes": episodes,
        "mean_return": float(returns.mean()),
        "std": float(returns.std(correction=0)),
        "mean_length": float(lengths.mean()),
        "unfinished": int(alive.sum()),
    }


@torch.no_grad()
def render_frames(env, policy, out_dir: str, seed: int = 0, greedy: bool = False,
                  n_frames: int = 60) -> list:
    """Write ``n_frames`` frames of env 0 of the evaluation's reset under
    ``policy`` (None: uniform random actions) to ``out_dir``: sampled
    actions (Gumbel argmax, message bits by their sigmoid) unless
    ``greedy``.  Returns the paths written."""
    from rware_tpu_torch.models.ippo import policy_obs_fn
    from rware_tpu_torch.models.networks import sample_action, sample_bernoulli
    from rware_tpu_torch.parallel import batched_reset
    from rware_tpu_torch.rendering import Viewer

    os.makedirs(out_dir, exist_ok=True)
    viewer = Viewer(env.config)
    state, _ = batched_reset(env, seed, 1)
    gen = torch.Generator(device=env.device).manual_seed(seed + 2)
    observe = policy_obs_fn(env)
    if policy is not None:
        policy = policy.to(env.device)
    carry = None if policy is None else _initial_carry(policy, 1, env.n_agents, env.device)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    paths = []
    for t in range(n_frames):
        frame = viewer.frame(state)
        path = os.path.join(out_dir, f"frame_{t:03d}.{'png' if Image else 'npy'}")
        if Image is not None:
            Image.fromarray(frame).save(path)
        else:
            np.save(path, frame)
        paths.append(path)
        if policy is None:
            actions = env.sample_actions(gen, 1)
        else:
            logits, carry = policy_logits(policy, observe(state), carry)
            if greedy:
                actions = greedy_actions(logits)
            else:
                move, msg = logits if isinstance(logits, tuple) else (logits, None)
                actions, _ = sample_action(move, torch.rand(move.shape, generator=gen,
                                                            device=env.device))
                if msg is not None:
                    bits, _ = sample_bernoulli(msg, torch.rand(msg.shape, generator=gen,
                                                               device=env.device))
                    actions = torch.cat([actions[..., None], bits], dim=-1)
        state = env.step(state, actions, gen).state
    return paths


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--env", default=None, help="default: the checkpoint's env")
    p.add_argument("--episodes", type=int, default=128)
    p.add_argument("--max-steps", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--random", action="store_true", help="uniform random policy baseline")
    p.add_argument("--greedy", action="store_true",
                   help="argmax moves, message bits where their logit is > 0")
    p.add_argument("--render-frames", default=None, help="dir for 60 PNG frames of env 0")
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
    if args.greedy and not args.random:
        stats = greedy_return(env, policy, args.episodes, args.max_steps, args.seed)
    else:
        stats = mean_return(env, policy, args.episodes, args.max_steps, args.seed)
    print(f"episodes={stats['episodes']} mean_return={stats['mean_return']:.3f} "
          f"std={stats['std']:.3f} mean_length={stats['mean_length']:.1f} "
          f"unfinished={stats['unfinished']}", flush=True)
    if args.render_frames:
        paths = render_frames(env, None if args.random else policy, args.render_frames,
                              args.seed, args.greedy)
        print(f"wrote {len(paths)} frames to {args.render_frames}", flush=True)
    return stats


if __name__ == "__main__":
    main()
