"""Train IPPO, MAPPO or SEAC-PPO, each with an MLP or a GRU policy, or SEAC
A2C with MLP policies, on a warehouse config — the port's counterpart of
``train.py`` (algo ``ippo``, ``mappo`` or ``seac-ppo`` with net ``mlp`` or
``gru``; algo ``seac``).

Examples::

    python -m rware_tpu_torch.train --device cuda --env rware-tiny-2ag-v2 \\
        --n-envs 4096 --updates 300 --checkpoint-dir ckpts/run1
    python -m rware_tpu_torch.train --device cuda --algo mappo --n-envs 4096 --updates 400
    python -m rware_tpu_torch.train --device cuda --net gru --n-envs 4096 --updates 800 \\
        --ent-coef 0.03 [--fused-loss]
    python -m rware_tpu_torch.train --device cuda --algo mappo --net gru --n-envs 4096 \\
        --updates 400 --ent-coef 0.03 [--msg-bits 2]
    python -m rware_tpu_torch.train --device cuda --algo seac-ppo --n-envs 4096 --updates 800 \\
        --ent-coef 0.03
    python -m rware_tpu_torch.train --device cuda --algo seac-ppo --net gru --n-envs 4096 \\
        --updates 800 --ent-coef 0.03 [--msg-bits 2]
    python -m rware_tpu_torch.train --device cuda --algo seac --n-envs 1024 --updates 2000 \\
        --profile-dir traces/seac
    python -m rware_tpu_torch.train --device cuda --msg-bits 2 --n-envs 4096 --updates 400
    python -m rware_tpu_torch.train --device cuda --env rware-img-tiny-2ag-v2 --net gru \\
        --n-envs 4096 --updates 800 --ent-coef 0.03
    python -m rware_tpu_torch.train --device cpu --n-envs 128 --rollout-len 8 --updates 2
    python -m rware_tpu_torch.train --device cpu --algo mappo --collect plain --n-envs 128 \
        --rollout-len 8 --updates 2 [--msg-bits 2]

``--collect fused`` (default) trains through the fused collector (K2a) and,
for ``--algo ippo``, the whole-update-phase kernel (K3); for ``--algo mappo``
through the critic-values kernel (K6) and one combined actor + critic gradient
kernel launch (K5) per pass, or with ``--fused-critic-phase`` the
whole-MAPPO-phase kernel (K7).  ``--net gru`` trains the recurrent policy
through the recurrent collector (K2c) and, per env-band pass, the GRU
forward and backward sequence kernels (K9, K10); ``--fused-loss`` takes
each pass from the iall-fed forward (K11) and the loss-fused backward (K13)
instead, with the embed and input-gate products in torch (JAX's
``fused_loss``; no message bits).  ``--algo mappo --net gru`` trains the GRU
actor as ``--net gru`` does with ``vf_coef = 0`` and the central critic per
env band through the critic-only gradient kernel (K5), after K2c and K6.
``--algo seac-ppo`` trains
one MLP per agent through the per-agent collector (K2d) and, per pass, the
per-agent SEAC gradient kernel (K8); with ``--net gru`` one GRU per agent
through the per-agent recurrent collector (K2d′) and, per env band, the
cross replay of every agent's GRU over every agent's stream by autograd.
``--algo seac`` trains SEAC A2C: one MLP per agent, rollouts of 5 steps
(``--rollout-len``'s default for it; 128 for the others) through the
per-agent collector (K2d), then one update by autograd of the cross
forwards; SEAC A2C has MLP policies only, and ``--net gru`` raises.  On the
CPU each runs its plain version.  ``--collect plain`` runs the plain
learner of the algo and net (``models/ippo.build_train_step``,
``models/ippo_rnn.build_rnn_train_step`` with ``--net gru``, the per-agent
collector's plain version for ``--algo seac-ppo`` with the MLP and for
``--algo seac``), and for ``--algo mappo`` and ``--algo seac-ppo --net gru``
JAX's ``--collect xla`` learners (``train.py:199-212, 230-243``), which run no
kernel on any device: the plain collect of
``parallel/rollout.build_scan_collect`` with the actor, or each agent's GRU,
in flax's rounding, then MAPPO's critic values, GAE and E x M time-window
passes by autograd (``models/mappo.MappoPlainTrainStep``), or recurrent
SEAC-PPO's cross replay and band passes as with K2d′.  Recurrent MAPPO has
no such learner, in JAX either (``train.py:170-173``), and
``--fused-critic-phase`` is the fused path's.  ``--msg-bits M``
gives every agent M message bits (the env's ``MultiDiscrete([5, 2, ...,
2])`` action;
``train.py:45-49``) and trains the Bernoulli message head: for ``--algo
ippo`` through the collectors' message mode (K2b) and, per pass, the PPO
gradient kernel with the message head (K4; K3 has none); for ``--algo mappo``
on JAX's split path (K4 for the actor, the critic by autograd); for ``--algo
seac-ppo`` with the MLP through K2d's message mode and JAX's flat update by
autograd (K8 has no message head), with the GRU through K2d′'s; for ``--algo
seac`` through K2d's message mode.  Every algo
and net takes image ids (``-img``, ``-imgdict``, ``-Nd``): the collectors then
build each agent's window in their image mode (K2e) and the policy takes
``policy_obs_length`` features.  The device is never chosen for you:
``--device cuda`` without a GPU raises.

The log prints every ``--log-every`` updates (one device sync each) and, at
the end, ``timing: X ms p50 / Y ms p95 per update (Z M env-steps/s)`` over
the logged windows after the first (``profiling.StepTimer``).
``--profile-dir DIR`` traces updates ``[start + 3, start + 6)`` with
``torch.profiler`` (the card's kernels and copies too on a CUDA device) into
``DIR/<host>_<pid>.<ns>.pt.trace.json`` (``profiling.TraceWindow``); the
windows that hold traced updates are left out of the timing line.

``--checkpoint-dir`` writes the final policy with ``torch.save`` to
``<checkpoint-dir>/policy.pt``, with its net kind under ``net`` and its
message bits under ``msg_bits``; a MAPPO run adds its central critic under
the key ``critic``, a SEAC run (A2C or PPO) holds one network per agent and
says how many under ``per_agent``.  Every ``--checkpoint-every`` updates, and
at the end, the whole runner is saved there too (``rware_tpu_torch.checkpoint``,
the last three kept); ``--resume`` restores the latest and trains on to
``--updates``, the same updates an unbroken run takes.

``--distributed`` joins a ``torch.distributed`` process group
(``rware_tpu_torch.distributed.initialize``: ``RWARE_COORD_ADDR`` /
``RWARE_NUM_PROCS`` / ``RWARE_PROC_ID``, else torchrun's environment; NCCL
on a CUDA device, gloo on the CPU), one process a GPU, each on
``cuda:LOCAL_RANK``, and reduces the logged metrics across the processes
(``profiling.aggregate_across_hosts``).  ``--mesh`` then trains data
parallel over them (``parallel.sharding``): each rank holds ``--n-envs /
world`` envs, and every pass all-reduces the gradients.  Over more than one
process ``--distributed`` needs ``--mesh``.  It takes every learner JAX's
``train.py`` puts on a mesh, with JAX's statistics: the ones JAX builds with
``mesh=`` (IPPO per pass, recurrent IPPO with or without ``--fused-loss``,
MAPPO per pass, recurrent MAPPO, recurrent SEAC-PPO; MAPPO and recurrent
SEAC-PPO with ``--collect plain`` too) normalise each shard's advantages over
the shard, as ``shard_map`` does; the ones JAX only places
on the mesh (``--collect plain`` for ``--algo ippo`` with ``--net mlp`` or
``gru``, ``--algo seac-ppo`` with the MLP, with or without ``--msg-bits``, and
``--algo seac``) take every statistic over the whole batch, so that an update over
the ranks is the one-process update of the global batch.  What JAX refuses
under a mesh stays refused: K3 (the mesh takes IPPO per pass) and
``--fused-critic-phase`` (K7).  At world size 1 ``--mesh`` changes nothing.
Only rank 0 prints the log and writes ``policy.pt``; every rank writes its
runner shard (``<step>.rank<r>-of<W>.pt``)::

    python -m torch.distributed.run --nproc-per-node 2 -m rware_tpu_torch.train \
        --distributed --mesh --device cuda --n-envs 32768 --updates 300
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from rware_tpu_torch.core.env import resolve_device

NO_LEARNER = ("no such learner, in the JAX package either: --fused-critic-phase is MAPPO's "
              "whole-phase kernel, for --algo mappo --net mlp --collect fused without message "
              "bits (mappo.py:386-393), and --collect plain is JAX's --collect xla, which "
              "recurrent MAPPO does not have (train.py:170-173)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--env", default="rware-tiny-2ag-v2")
    p.add_argument("--algo", choices=["ippo", "mappo", "seac", "seac-ppo"], default="ippo")
    p.add_argument("--net", choices=["mlp", "gru"], default="mlp")
    p.add_argument("--collect", choices=["fused", "plain"], default="fused",
                   help="fused = the collector and update kernels; plain = the plain "
                        "learner of the algo and net")
    p.add_argument("--fused-critic-phase", action="store_true",
                   help="mappo: the whole update phase in the K7 kernel (default: K5 per pass)")
    p.add_argument("--fused-loss", action="store_true",
                   help="ippo --net gru: each band pass by K11 and the loss-fused backward K13 "
                        "(default: K9 and K10 around the loss)")
    p.add_argument("--minibatch-mode", choices=["shuffle", "block"], default="shuffle",
                   help="minibatches of the plain learner (the fused path takes time windows)")
    p.add_argument("--msg-bits", type=int, default=None,
                   help="override the env's message-channel width (ids cannot express it) "
                        "and train the Bernoulli message head")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    p.add_argument("--updates", type=int, default=100)
    p.add_argument("--n-envs", type=int, default=256)
    p.add_argument("--rollout-len", type=int, default=None,
                   help="steps per rollout (default: 5 for --algo seac, else 128)")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=50,
                   help="save the whole runner every N updates (with --checkpoint-dir)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest runner saved in --checkpoint-dir and train on")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of updates [start+3, start+6) here")
    p.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed process group (torchrun or RWARE_* variables)")
    p.add_argument("--mesh", action="store_true",
                   help="shard the envs over the process group's ranks (data parallel)")
    return p.parse_args(argv)


def distributed_device(dev: torch.device) -> torch.device:
    """This process's device in a distributed run: ``cuda:LOCAL_RANK`` for a
    CUDA device given without an index, refused where that index is not
    there."""
    if dev.type != "cuda":
        return dev
    index = dev.index if dev.index is not None else int(os.environ.get("LOCAL_RANK", "0"))
    if not 0 <= index < torch.cuda.device_count():
        raise ValueError(f"cuda:{index} does not exist: {torch.cuda.device_count()} device(s)")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def save_policy(path: str, env_id: str, dims, params: torch.Tensor, updates: int,
                cdims=None, cparams=None) -> None:
    """``torch.save`` of the policy: its net kind (``"mlp"``: an
    ``ActorCritic``; ``"gru"``: a ``RecurrentActorCritic``), sizes and state
    dict, and under ``critic`` those of MAPPO's ``CentralCritic``.  An (N, P)
    ``params`` stack (SEAC) is N nets of the kind, one per agent, saved as one
    ``nn.ModuleList`` with ``per_agent: N``."""
    from rware_tpu_torch.models.ippo import policy_of
    from rware_tpu_torch.models.ippo_rnn import rnn_policy_of
    from rware_tpu_torch.models.networks import GruDims, arrays_to_critic
    from rware_tpu_torch.models.seac import seac_gru_policies_of, seac_policies_of

    ckpt = {"env": env_id, "obs_dim": dims.obs_len, "n_actions": dims.n_actions,
            "msg_bits": dims.msg_bits, "updates": updates}
    gru = isinstance(dims, GruDims)
    if gru:
        ckpt.update(net="gru", hidden=dims.hidden, embed=dims.embed)
    else:
        ckpt.update(net="mlp", hidden=(dims.h1, dims.h2))
    if params.dim() == 2:
        policies_of = seac_gru_policies_of if gru else seac_policies_of
        model = policies_of(dims, params.cpu())
        ckpt.update(per_agent=params.shape[0])
    else:
        model = (rnn_policy_of if gru else policy_of)(dims, params.cpu())
    ckpt["state_dict"] = model.state_dict()
    if cdims is not None:
        critic = arrays_to_critic(cdims.split(cparams.detach().cpu()))
        ckpt["critic"] = {"n_agents": cdims.n_agents, "joint_dim": cdims.joint_len,
                          "hidden": (cdims.h1, cdims.h2), "state_dict": critic.state_dict()}
    torch.save(ckpt, path)


def load_policy(path: str, device="cpu"):
    """(env id, policy) of a file written by :func:`save_policy`: an
    ``ActorCritic``, for net kind ``"gru"`` a ``RecurrentActorCritic``, and
    with ``per_agent: N`` an ``nn.ModuleList`` of N of them, agent i running
    the i-th (a file without a kind is an MLP's)."""
    from torch import nn

    from rware_tpu_torch.models.networks import ActorCritic, RecurrentActorCritic

    ckpt = torch.load(path, map_location="cpu")
    net, msg_bits = ckpt.get("net", "mlp"), ckpt.get("msg_bits", 0)
    if net == "gru":
        def build():
            return RecurrentActorCritic(ckpt["obs_dim"], ckpt["n_actions"], ckpt["hidden"],
                                        ckpt["embed"], msg_bits)
    elif net == "mlp":
        def build():
            return ActorCritic(ckpt["obs_dim"], ckpt["n_actions"], tuple(ckpt["hidden"]),
                               msg_bits)
    else:
        raise ValueError(f"{path}: unknown net kind {net!r}")
    model = nn.ModuleList(build() for _ in range(ckpt["per_agent"])) \
        if "per_agent" in ckpt else build()
    model.load_state_dict(ckpt["state_dict"])
    return ckpt["env"], model.to(device)


def main(argv=None) -> dict:
    args = parse_args(argv)
    mappo, seac, a2c = args.algo == "mappo", args.algo == "seac-ppo", args.algo == "seac"
    gru, msg = args.net == "gru", bool(args.msg_bits)
    if args.fused_loss and (args.algo != "ippo" or not gru or args.collect != "fused"):
        raise ValueError("--fused-loss is the recurrent IPPO learner's option (--net gru "
                         "--collect fused)")
    if a2c and gru:
        raise ValueError("--algo seac (SEAC A2C) has MLP policies only (seac.py:61-98); "
                         "recurrent SEAC is --algo seac-ppo --net gru")
    if (args.collect == "plain" and mappo and gru) or (args.fused_critic_phase and (
            msg or gru or not mappo or args.collect == "plain")):
        raise NotImplementedError(
            f"--algo {args.algo} --net {args.net} --collect {args.collect}"
            f"{' --fused-critic-phase' * args.fused_critic_phase}"
            f"{f' --msg-bits {args.msg_bits}' * msg}: {NO_LEARNER}")
    dev = resolve_device(args.device)
    rank, world, mesh, own_group = 0, 1, None, False
    if args.distributed:
        import torch.distributed as dist

        from rware_tpu_torch.distributed import initialize

        dev = distributed_device(dev)
        own_group = not dist.is_initialized()  # a caller's group is kept (initialize)
        rank, world = initialize(device=dev)
        print(f"distributed: process {rank}/{world}", flush=True)
    if world > 1 and not args.mesh:
        raise ValueError(f"--distributed over {world} processes needs --mesh: without it every "
                         "process would train the whole batch and write the same checkpoints")
    if args.mesh and world > 1:
        from rware_tpu_torch.parallel.sharding import make_mesh

        mesh = make_mesh(device=dev)

    import rware_tpu_torch
    from rware_tpu_torch.metrics import MetricLogger
    from rware_tpu_torch.models.ippo import IPPOConfig, build_train_step, init_runner
    from rware_tpu_torch.models.ippo_fused import build_fused_train_step
    from rware_tpu_torch.models.ippo_rnn import (
        build_rnn_fused_train_step,
        build_rnn_train_step,
        init_rnn_runner,
    )
    from rware_tpu_torch.models.mappo import (
        build_mappo_train_step,
        build_rnn_mappo_train_step,
        init_mappo_runner,
        init_rnn_mappo_runner,
    )
    from rware_tpu_torch.models.seac import (
        SEACConfig,
        SEACPPOConfig,
        build_seac_gru_train_step,
        build_seac_ppo_fused_train_step,
        build_seac_ppo_train_step,
        build_seac_train_step,
        init_seac,
        init_seac_gru,
        init_seac_ppo,
    )
    from rware_tpu_torch.profiling import StepTimer, TraceWindow, aggregate_across_hosts

    overrides = {} if args.msg_bits is None else {"msg_bits": args.msg_bits}
    env = rware_tpu_torch.make(args.env, device=dev, **overrides)
    rollout_len = args.rollout_len or (5 if a2c else 128)  # train.py:107, 283
    cfg = IPPOConfig(n_envs=args.n_envs, rollout_len=rollout_len, lr=args.lr,
                     ent_coef=args.ent_coef, minibatch_mode=args.minibatch_mode)
    cdims = None
    if a2c:
        # train.py:274-288: the run sets the batch, the rollout, lr and ent_coef
        cfg = SEACConfig(n_envs=args.n_envs, rollout_len=rollout_len, lr=args.lr,
                         ent_coef=args.ent_coef)
        runner, dims = init_seac(env, cfg, args.seed, mesh=mesh)
        train_step = build_seac_train_step(env, dims, cfg, collect=args.collect, mesh=mesh)
    elif seac:
        # train.py:254-259: the run sets the batch, the rollout, lr and ent_coef
        cfg = SEACPPOConfig(n_envs=args.n_envs, rollout_len=rollout_len, lr=args.lr,
                            ent_coef=args.ent_coef)
        if gru:
            runner, dims = init_seac_gru(env, cfg, args.seed, mesh=mesh)
            train_step = build_seac_gru_train_step(env, dims, cfg, mesh=mesh,
                                                   collect=args.collect)
        else:
            runner, dims = init_seac_ppo(env, cfg, args.seed, mesh=mesh)
            if args.collect == "fused" and not msg:
                train_step = build_seac_ppo_fused_train_step(env, dims, cfg, mesh=mesh)
            else:  # K8 has no message head: JAX's flat update (seac.py:343-345)
                train_step = build_seac_ppo_train_step(env, dims, cfg, collect=args.collect,
                                                       mesh=mesh)
    elif mappo and gru:
        runner, dims, cdims = init_rnn_mappo_runner(env, cfg, args.seed, mesh=mesh)
        train_step = build_rnn_mappo_train_step(env, dims, cdims, cfg, mesh=mesh)
    elif mappo:
        runner, dims, cdims = init_mappo_runner(env, cfg, args.seed, mesh=mesh)
        train_step = build_mappo_train_step(env, dims, cdims, cfg,
                                            fused_critic_phase=args.fused_critic_phase,
                                            mesh=mesh, collect=args.collect)
    elif gru:
        runner, dims = init_rnn_runner(env, cfg, args.seed, mesh=mesh)
        if args.collect == "fused":
            train_step = build_rnn_fused_train_step(env, dims, cfg, fused_loss=args.fused_loss,
                                                    mesh=mesh)
        else:
            train_step = build_rnn_train_step(env, dims, cfg, mesh=mesh)
    else:
        runner, dims = init_runner(env, cfg, args.seed, mesh=mesh)
        if args.collect == "fused":
            train_step = build_fused_train_step(env, dims, cfg, mesh=mesh)
        else:
            train_step = build_train_step(env, dims, cfg, mesh=mesh)
    if mesh is not None:
        from rware_tpu_torch.parallel.sharding import replicate

        # train.py:291-303: the parameters and the optimizer state as rank 0 has them
        runner = dataclasses.replace(runner, params=replicate(runner.params, mesh),
                                     opt_state=replicate(runner.opt_state, mesh))
        print(f"sharded {args.n_envs} envs over {world} processes", flush=True)
    ckpts, start, saved = None, 0, None
    if args.checkpoint_dir:
        from rware_tpu_torch.checkpoint import Checkpointer

        ckpts = Checkpointer(os.path.join(args.checkpoint_dir, "runner"),
                             rank=mesh.rank if mesh else 0, world=mesh.world if mesh else 1)
        if args.resume:
            try:
                runner = ckpts.restore(template=runner)
            except FileNotFoundError:
                pass
            else:
                start = saved = runner.update_idx
                print(f"resumed from update {start}", flush=True)
    env_steps_per_update = cfg.n_envs * cfg.rollout_len
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    lead = rank == 0  # the process that prints the log and writes policy.pt
    if lead:
        print(f"training {args.algo} ({args.net}, {env.config.msg_bits} message bits) on "
              f"{args.env} on {dev} ({card}): {args.updates} updates x {env_steps_per_update} "
              f"env-steps, collect {args.collect}", flush=True)
    log_every = max(1, args.log_every)
    logger = MetricLogger(print_every=1 if lead else 0)
    timer = StepTimer(skip_first=1)  # the first window holds the kernel build and warm-up
    tracer = TraceWindow(args.profile_dir, start=start + 3, device=dev) \
        if args.profile_dir else None
    last_u, entry = start, {}
    timer.tick()
    for u in range(start, args.updates):
        if tracer:
            tracer.step(u)
        runner, metrics = train_step(runner)
        if ckpts and (u + 1) % args.checkpoint_every == 0:
            ckpts.save(u + 1, runner)
            saved = u + 1
        if (u + 1) % log_every and u + 1 != args.updates:
            continue
        if args.distributed:  # train.py:343-345
            metrics = aggregate_across_hosts({k: float(v) for k, v in metrics.items()})
        # one device sync per logged window; the rate is the window's
        entry = logger.log(u + 1, metrics, env_steps_per_update * (u + 1 - last_u))
        # a window holding traced updates carries torch.profiler's overhead
        traced = tracer is not None and last_u < tracer.stop and u + 1 > tracer.start
        timer.tick(n_steps=u + 1 - last_u, record=not traced)
        last_u = u + 1
    if tracer:
        tracer.close()
    stats = timer.summary()
    if stats and lead:
        print(f"timing: {stats['step_ms_p50']:.1f}ms p50 / {stats['step_ms_p95']:.1f}ms p95 "
              f"per update ({stats['steps_per_s'] * env_steps_per_update / 1e6:.2f}M "
              f"env-steps/s{'; traced updates left out' if tracer else ''})", flush=True)
    if args.checkpoint_dir and saved != runner.update_idx:
        ckpts.save(runner.update_idx, runner)
    if args.checkpoint_dir and lead:
        path = os.path.join(args.checkpoint_dir, "policy.pt")
        if mappo:
            save_policy(path, args.env, dims, runner.params["actor"], args.updates, cdims,
                        runner.params["critic"])
        else:
            save_policy(path, args.env, dims, runner.params, args.updates)
        print(f"saved {path}", flush=True)
    if lead:
        print("done:", {k: round(v, 4) for k, v in entry.items()
                        if "loss" in k or "reward" in k or "env_steps" in k}, flush=True)
    if own_group and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return entry


if __name__ == "__main__":
    main()
