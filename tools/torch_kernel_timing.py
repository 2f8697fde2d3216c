#!/usr/bin/env python3
"""Time the port's fused kernels on a CUDA GPU and show where a main-path
call spends its device time.

For each config: the fused rollout kernel (K1, random mode) at B=65,536,
T=256, the fused collector kernel (K2a, hidden (128, 128)) and the recurrent
collector kernel (K2c, embed 128, GRU hidden 128) at B=16,384, T=128, and the
GRU sequence kernels (K9 forward, K10 backward) on a band of a quarter of
that trajectory's envs.  Each timing is the median of ``--repeats`` launches timed
with CUDA events after one warm-up launch, with the spread (min, max) beside
it.  ``--profile`` adds one torch.profiler window per kernel on tiny-2ag:
device time by kernel name and the device-busy share of the call's wall
time.  ``--train-step`` times ``--repeats`` updates of the fused learner
(``models/ippo_fused.build_fused_train_step``, tiny-2ag, B=16,384, T=128,
E=4, M=4), each alone, then twice the mean of three issued back to back (as
``chip_smoke.py`` times a learner), and profiles one; with ``--algo mappo`` the learner is
``models/mappo.build_mappo_train_step``, per pass (K5) and, with
``--fused-critic-phase``, whole phase (K7); with ``--net gru`` it is the
recurrent learner ``models/ippo_rnn.build_rnn_fused_train_step`` (K2c, and
K9 + K10 per band pass); with ``--algo seac-ppo`` it is the SEAC-PPO learner
``models/seac.build_seac_ppo_fused_train_step`` (K2d, and K8 per pass), with
``--net gru`` the recurrent one ``models/seac.build_seac_gru_train_step``
(K2d′, and the cross replay by autograd per env band); with ``--algo mappo
--net gru`` recurrent MAPPO ``models/mappo.build_rnn_mappo_train_step`` (K2c,
K6, and K9 + K10 + critic-only K5 per band); with ``--net gru --fused-loss``
the loss-fused recurrent learner (K11 + K13 per band), and each config then
also times K11, K12 and K13 on the GRU kernels' band; each config also
times the per-agent collector kernels (K2d and K2d′, B=16,384, T=128) and the
SEAC-PPO gradient kernel (K8, one 32-row window of B=16,384 random data).
``--msg-bits M`` gives every config M message bits: K1 and the GRU kernels
then run on the longer observation, K2a, K2c, K2d and K2d′ in their message
mode (K2b), and each config also times the PPO gradient kernel with the
message head (K4, one 32-row window of B=16,384 random data; K8 has none);
the train step is then the message-bit learner of ``--algo`` and ``--net``
(IPPO per pass, MAPPO's split path, SEAC-PPO's flat update).  ``--n-envs``
sets the train step's batch (16,384; BASELINE.md's recurrent SEAC runs
4,096), ``--env`` its env and the profile's (tiny-2ag).  Image ids
(``-img``, ``-imgdict``, ``-Nd``) are configs like any other: the
collectors then run in their image mode (K2e) and every policy takes
``policy_obs_length`` features.  Prints one JSON object per line, each with the card's name and power
limit; ``--out`` also writes them to a file.

``--ppo-kernels`` times only the PPO gradient kernels at the main shape on
random data (tiny-2ag, B=16,384, T=128, E=4, M=4, hidden (128, 128)): K3's
whole phase, K4 on one window, K8 on one window, K7's whole phase, K5 with
and without the actor on one window and K6 on the trajectory, each beside
its plain version where ``--plain`` asks for it, and K3 split into its
kernels where the checkout times that (``FusedPPOUpdatePhase.timed``).
``--collect-kernels`` times only the collectors at the main shape (tiny-2ag,
B=16,384, T=128, hidden (128, 128), random mode): the MLP collector K2a, K2a
with K2b (two message bits), K2a with K2e (``rware-img-tiny-2ag-v2``), K2d and
K2d with K2b, each agent its own network, then K1 (B=65,536, T=256), the
recurrent collector K2c (embed 128, GRU 128), K2c with K2b and K2c with K2e,
and K2d′ and K2d′ with K2b (B=4,096), each beside its plain version where
``--plain`` asks for it and with the recurrent collector's tile where the
checkout plans one; then it prints a digest of K2a's outputs on
``chip_smoke.py``'s phase-4 cases, so that two checkouts' K2a can be held bit
for bit to each other.
``--gru-seq-kernels`` times only the iall-fed GRU kernels alone at the band
shape (tiny-2ag, B=16,384, T=128, a 4,096-env band that wraps, embed 128, GRU
128, ``testing.random_gru_seq_case``): K11, K12 and K13, each beside its plain
version where ``--plain`` asks for it, and K12's and K13's split into
prologue, sweep, dWh and reduction where the checkout times it (the median of
``--repeats`` timed launches); then it prints a digest of K10's outputs (with
K9's hidden sequence) on ``chip_smoke.py``'s phase-13 cases, so that two
checkouts' K10 can be held bit for bit to each other.
``--rollout-kernels`` times only the fused rollout kernel (K1, random mode)
at its main shape (B=65,536, T=256) on each of ``--configs`` with no message
bits and with two, beside its plain version on tiny-2ag where ``--plain``
asks for it, with its launch plan (route, tile) where the checkout has one;
``--route`` forces one of the plan's routes on every config.
``--library-gru`` times ``torch.nn.GRU`` in bf16 at K9's band shape (T=128,
8,192 sequences, 128 inputs, hidden 128) as a yardstick for K9's recurrence:
it is not K9's function (no embed, no resets where an episode ends) and the
port calls it nowhere.
``--tree DIR`` imports ``rware_tpu_torch`` from the checkout DIR (an unpacked
older commit, say) so that two commits are timed by the same script on one
card: run it as old, new, new, old.

Usage: python tools/torch_kernel_timing.py [--configs ...] [--profile] [--train-step]
       [--algo ippo|mappo|seac-ppo] [--net mlp|gru] [--fused-critic-phase] [--fused-loss]
       [--msg-bits M]
       [--n-envs B] [--env ID] [--out FILE]
       python tools/torch_kernel_timing.py --ppo-kernels [--tree DIR] [--plain] [--out FILE]
       python tools/torch_kernel_timing.py --collect-kernels [--tree DIR] [--plain] [--out FILE]
       python tools/torch_kernel_timing.py --gru-seq-kernels [--tree DIR] [--plain] [--out FILE]
       python tools/torch_kernel_timing.py --rollout-kernels [--configs ...] [--route R]
       [--tree DIR] [--plain] [--out FILE]
       python tools/torch_kernel_timing.py --library-gru [--out FILE]
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def time_launches(fn, repeats, times=None):
    """(median, min, max) ms of ``repeats`` calls after a warm-up, each
    timed alone with a sync after it; ``times`` receives each call's ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = [] if times is None else times
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), min(times), max(times)


def back_to_back_ms(fn, repeats):
    """Mean ms of ``repeats`` calls issued with no sync between them, as
    ``chip_smoke.py`` times a learner's three updates."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def profile(fn):
    """(device ms by kernel name, device-busy share of the wall window)."""
    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for evt in prof.key_averages():
        # Device-side events only: a host op's device time repeats its kernels'.
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            name = evt.key[:80]
            by_name[name] = by_name.get(name, 0.0) + dev_us / 1e3
    busy = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
    return top, busy, wall_ms


def gru_tile(collect, b) -> dict:
    """The tile a recurrent collector takes for ``b`` envs: its launch plan
    where the checkout has one (``collect.plan``), else the one-thread-per-env
    kernel's threads and route."""
    if callable(getattr(collect, "plan", None)):
        plan = collect.plan(b)
        return {"te": plan.te, "threads": plan.threads, "blocks": plan.blocks(b),
                "bias_and_heads": "device memory" if plan.heads_global else "shared memory"}
    return {"threads": collect.threads,
            "bias_and_heads": "shared memory" if collect.smem_stacks else "device memory"}


def rollout_kernels(tree, configs, route, repeats, plain, emit, dev):
    """K1 alone at its main shape (see the module's docstring)."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.ops.fused_rollout import build_fused_rollout
    from rware_tpu_torch.parallel import batched_reset

    b, t = 65536, 256
    for env_id in configs:
        for m in (0, 2):
            env = rware_tpu_torch.make(env_id, device=dev, msg_bits=m)
            states, _ = batched_reset(env, 0, b)
            roll = build_fused_rollout(env.config, t)
            rec = {"tree": tree, "kernel": "fused_rollout (K1)", "env": env_id, "msg_bits": m,
                   "B": b, "T": t}
            if callable(getattr(roll, "plan", None)):
                roll.route = route
                plan = roll.plan(b)
                rec["plan"] = {"route": plan.route, "te": plan.te, "smem": plan.smem,
                               "rows": plan.rows}
            med, lo, hi = time_launches(lambda: roll(states, 1), repeats)
            rec.update(ms_median=med, ms_min=lo, ms_max=hi, env_steps_per_s=b * t / med * 1e3)
            if plain and env_id == "rware-tiny-2ag-v2":
                rec["plain_ms"] = time_launches(lambda: roll.plain(states, 1), 1)[0]
            emit(rec)
            del states, roll
            torch.cuda.empty_cache()


def seac_kernels(env, env_id, states, repeats, emit):
    """K2d and K2d′ on ``states`` (B=16,384, T=128), each agent its own
    network, and (without message bits) K8 on one 32-row window of random
    data of the same batch, at ``env``'s agent count."""
    import torch
    from rware_tpu_torch.models.networks import init_actor_critic, init_recurrent_actor_critic
    from rware_tpu_torch.ops.fused_rollout import (
        build_fused_collect_gru_per_agent,
        build_fused_collect_per_agent,
    )
    from rware_tpu_torch.ops.fused_seac import build_fused_seac_grads
    from rware_tpu_torch.testing import random_seac_case

    b, t, t_mb = states.batch_size, 128, 32
    n, m, length = env.n_agents, env.config.msg_bits, env.config.policy_obs_length
    policies = torch.nn.ModuleList(init_actor_critic(length, 5, (128, 128), (0, 2, i), m)
                                   for i in range(n)).to(env.device)
    collect = build_fused_collect_per_agent(env.config, t)
    med, lo, hi = time_launches(lambda: collect(states, policies, 1), repeats)
    emit({"kernel": "fused_collect_per_agent", "env": env_id, "B": b, "T": t,
          "weights": "device memory" if collect.weights_global else "shared memory",
          "ms_median": med, "ms_min": lo, "ms_max": hi, "env_steps_per_s": b * t / med * 1e3})
    grus = torch.nn.ModuleList(init_recurrent_actor_critic(length, 5, 128, 128, (0, 2, i), m)
                               for i in range(n)).to(env.device)
    carry = grus[0].initialize_carry((b, n))
    collect = build_fused_collect_gru_per_agent(env.config, t)
    med, lo, hi = time_launches(lambda: collect(states, grus, 1, carry), repeats)
    emit({"kernel": "fused_collect_gru_per_agent", "env": env_id, "B": b, "T": t,
          **gru_tile(collect, b), "ms_median": med, "ms_min": lo, "ms_max": hi,
          "env_steps_per_s": b * t / med * 1e3})
    if m:  # K8 has no message head
        return
    dims, params, data = random_seac_case(env_id, b, t_mb, 0, env.device)
    k8 = build_fused_seac_grads(dims, env.n_agents, t_mb, clip_eps=0.2, vf_coef=0.5,
                                ent_coef=0.01, seac_lambda=1.0)
    med, lo, hi = time_launches(lambda: k8(params, data, 0), repeats)
    emit({"kernel": "fused_seac_grads", "env": env_id, "B": b, "T_mb": t_mb, "ms_median": med,
          "ms_min": lo, "ms_max": hi,
          "pair_samples_per_s": t_mb * b * env.n_agents ** 2 / med * 1e3})
    del data
    torch.cuda.empty_cache()


def ppo_message_head(env_id, b, m, repeats, emit, dev):
    """K4 with the message head on one 32-row window of B envs of random data."""
    import torch
    from rware_tpu_torch.ops.fused_update import build_fused_ppo_grads
    from rware_tpu_torch.testing import random_ppo_case

    t_mb = 32
    dims, params, data = random_ppo_case(env_id, b, t_mb, 0, dev, m)
    k4 = build_fused_ppo_grads(dims, t_mb, clip_eps=0.2, vf_coef=0.5, ent_coef=0.01)
    med, lo, hi = time_launches(lambda: k4(params, data, 0), repeats)
    emit({"kernel": "fused_ppo_grads (message head)", "env": env_id, "B": b, "T_mb": t_mb,
          "ms_median": med, "ms_min": lo, "ms_max": hi,
          "samples_per_s": t_mb * b * data[1].shape[2] / med * 1e3})
    del data
    torch.cuda.empty_cache()


def ppo_kernels(tree, repeats, plain, emit, dev):
    """K3-K8 at the main shape on random data (see the module's docstring)."""
    import torch
    from rware_tpu_torch.models import ippo
    from rware_tpu_torch.models.ippo_fused import phase_advstats, phase_window_starts
    from rware_tpu_torch.ops.fused_mappo import (
        build_fused_critic_values,
        build_fused_mappo_grads,
        build_fused_mappo_update_phase,
    )
    from rware_tpu_torch.ops.fused_seac import build_fused_seac_grads
    from rware_tpu_torch.ops.fused_update import (
        build_fused_ppo_grads,
        build_fused_ppo_update_phase,
    )
    from rware_tpu_torch.testing import random_mappo_case, random_seac_case

    b, t_full, epochs, minibatches = 16384, 128, 4, 4
    t_mb, p = t_full // minibatches, epochs * minibatches
    cfg = ippo.IPPOConfig(epochs=epochs, minibatches=minibatches)
    kw = dict(clip_eps=cfg.clip_eps, vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef)
    base = {"tree": tree, "env": "rware-tiny-2ag-v2", "B": b, "T": t_full}

    def timed(name, fn, plain_fn=None, **extra):
        med, lo, hi = time_launches(fn, repeats)
        rec = dict(base, kernel=name, ms_median=med, ms_min=lo, ms_max=hi, **extra)
        if plain and plain_fn is not None:
            rec["plain_ms"] = time_launches(plain_fn, 1)[0]
        emit(rec)

    dims, cdims, params, data = random_mappo_case("rware-tiny-2ag-v2", b, t_full, 0, dev)
    gen = torch.Generator().manual_seed(0)
    starts = phase_window_starts(cfg, t_full, 4, gen).to(dev)
    advstats = phase_advstats(data[4], starts, t_mb)
    hyper = ippo.adam_hyper(cfg, 0, p).to(dev)
    actor = params["actor"]
    zero = torch.zeros_like(actor)
    k3 = build_fused_ppo_update_phase(dims, t_full, epochs, minibatches, cfg.clip_eps,
                                      cfg.vf_coef, cfg.ent_coef, cfg.max_grad_norm)
    args = (actor, zero, zero, data, starts, advstats, hyper)
    timed("fused_ppo_update_phase", lambda: k3(*args), lambda: k3.plain(*args), passes=p)
    if hasattr(k3, "timed"):
        k3.timed(*args)
        split = k3.timed(*args)[-1]
        emit(dict(base, kernel="fused_ppo_update_phase split, ms a pass", **split))
    k4 = build_fused_ppo_grads(dims, t_mb, **kw)
    timed("fused_ppo_grads", lambda: k4(actor, data, 5), lambda: k4.plain(actor, data, 5),
          T_mb=t_mb)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    k7 = build_fused_mappo_update_phase(dims, cdims, t_full, epochs, minibatches, cfg.clip_eps,
                                        cfg.vf_coef, cfg.ent_coef, cfg.max_grad_norm)
    args7 = (params, zeros, zeros, data, starts, advstats, hyper)
    timed("fused_mappo_update_phase", lambda: k7(*args7), lambda: k7.plain(*args7), passes=p)
    k5 = build_fused_mappo_grads(dims, cdims, t_mb, **kw)
    timed("fused_mappo_grads", lambda: k5(params, data, 5), lambda: k5.plain(params, data, 5),
          T_mb=t_mb)
    k5c = build_fused_mappo_grads(None, cdims, t_mb, with_actor=False, **kw)
    cdata = (data[0], data[3], data[5])
    timed("fused_mappo_grads (critic only)", lambda: k5c(params["critic"], cdata, 5),
          lambda: k5c.plain(params["critic"], cdata, 5), T_mb=t_mb)
    k6 = build_fused_critic_values(cdims)
    timed("fused_critic_values", lambda: k6(params["critic"], data[0]),
          lambda: k6.plain(params["critic"], data[0]))
    del data, args, args7, cdata
    torch.cuda.empty_cache()
    dims, sparams, sdata = random_seac_case("rware-tiny-2ag-v2", b, t_mb, 0, dev)
    k8 = build_fused_seac_grads(dims, sparams.shape[0], t_mb, seac_lambda=1.0, **kw)
    timed("fused_seac_grads", lambda: k8(sparams, sdata, 0), lambda: k8.plain(sparams, sdata, 0),
          T_mb=t_mb)


def collect_kernels(tree, repeats, plain, emit, dev):
    """The collectors at the main shape (see the module's docstring)."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models.networks import init_actor_critic, init_recurrent_actor_critic
    from rware_tpu_torch.ops.fused_rollout import (
        build_fused_collect,
        build_fused_collect_gru,
        build_fused_collect_gru_per_agent,
        build_fused_collect_per_agent,
        build_fused_rollout,
    )
    from rware_tpu_torch.parallel import batched_reset

    def timed(name, env_id, b, t, fn, plain_fn, **extra):
        med, lo, hi = time_launches(fn, repeats)
        rec = dict(tree=tree, kernel=name, env=env_id, B=b, T=t, ms_median=med, ms_min=lo,
                   ms_max=hi, env_steps_per_s=b * t / med * 1e3, **extra)
        if plain:
            rec["plain_ms"] = time_launches(plain_fn, 1)[0]
        emit(rec)
        torch.cuda.empty_cache()

    b, t = 16384, 128
    for name, env_id, m in (("fused_collect (K2a)", "rware-tiny-2ag-v2", 0),
                            ("fused_collect (K2a with K2b)", "rware-tiny-2ag-v2", 2),
                            ("fused_collect (K2a with K2e)", "rware-img-tiny-2ag-v2", 0)):
        env = rware_tpu_torch.make(env_id, device=dev, msg_bits=m)
        states, _ = batched_reset(env, 0, b)
        policy = init_actor_critic(env.config.policy_obs_length, 5, (128, 128), 0, m).to(dev)
        collect = build_fused_collect(env.config, t)
        timed(name, env_id, b, t, lambda: collect(states, policy, 1),
              lambda: collect.plain(states, policy, 1), msg_bits=m)
    for m in (0, 2):
        env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=dev, msg_bits=m)
        states, _ = batched_reset(env, 0, b)
        policies = torch.nn.ModuleList(
            init_actor_critic(env.config.policy_obs_length, 5, (128, 128), (0, 2, i), m)
            for i in range(env.n_agents)).to(dev)
        collect = build_fused_collect_per_agent(env.config, t)
        timed("fused_collect_per_agent (K2d%s)" % (" with K2b" if m else ""),
              "rware-tiny-2ag-v2", b, t, lambda: collect(states, policies, 1),
              lambda: collect.plain(states, policies, 1), msg_bits=m,
              weights="device memory" if collect.weights_global else "shared memory")
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=dev)
    states, _ = batched_reset(env, 0, 65536)
    roll = build_fused_rollout(env.config, 256)
    timed("fused_rollout (K1)", "rware-tiny-2ag-v2", 65536, 256, lambda: roll(states, 1),
          lambda: roll.plain(states, 1))
    for name, env_id, m in (("fused_collect_gru (K2c)", "rware-tiny-2ag-v2", 0),
                            ("fused_collect_gru (K2c with K2b)", "rware-tiny-2ag-v2", 2),
                            ("fused_collect_gru (K2c with K2e)", "rware-img-tiny-2ag-v2", 0)):
        env = rware_tpu_torch.make(env_id, device=dev, msg_bits=m)
        states, _ = batched_reset(env, 0, b)
        gru = init_recurrent_actor_critic(env.config.policy_obs_length, 5, 128, 128, 0,
                                          m).to(dev)
        carry = gru.initialize_carry((b, env.n_agents))
        collect = build_fused_collect_gru(env.config, t)
        timed(name, env_id, b, t, lambda: collect(states, gru, 1, carry),
              lambda: collect.plain(states, gru, 1, carry), msg_bits=m, **gru_tile(collect, b))
    bs = 4096
    for m in (0, 2):
        env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=dev, msg_bits=m)
        length = env.config.policy_obs_length
        states, _ = batched_reset(env, 0, bs)
        grus = torch.nn.ModuleList(init_recurrent_actor_critic(length, 5, 128, 128, (0, 2, i), m)
                                   for i in range(env.n_agents)).to(dev)
        carry = grus[0].initialize_carry((bs, env.n_agents))
        collect = build_fused_collect_gru_per_agent(env.config, t)
        timed("fused_collect_gru_per_agent (K2d′%s)" % (" with K2b" if m else ""),
              "rware-tiny-2ag-v2", bs, t, lambda: collect(states, grus, 1, carry),
              lambda: collect.plain(states, grus, 1, carry), msg_bits=m,
              **gru_tile(collect, bs))
    k2a_digests(tree, emit, dev)


def k2a_digests(tree, emit, dev):
    """A digest of K2a's outputs (trajectory and final state) on the cases of
    ``chip_smoke.py``'s phase 4, built as ``chip_smoke.compare_k2`` builds
    them, so that two checkouts' K2a can be held bit for bit to each other."""
    import hashlib

    import torch
    import chip_smoke
    import rware_tpu_torch
    from rware_tpu_torch.models import ActorCritic
    from rware_tpu_torch.ops.fused_rollout import build_fused_collect, pack_state
    from rware_tpu_torch.parallel import batched_reset

    cases = [(env_id, 1000, 32, det, 5, (128, 128), overrides)
             for env_id, overrides in chip_smoke.K2_CONFIGS for det in (True, False)]
    cases += [(chip_smoke.NARROW_CASE[0], 1000, 32, det, 5, chip_smoke.NARROW_CASE[1], {})
              for det in (True, False)]
    cases.append(("rware-tiny-2ag-v2", 16384, 128, False, 13, (128, 128), {}))
    for env_id, b, t, det, seed, hidden, overrides in cases:
        env = rware_tpu_torch.make(env_id, device=dev, **overrides)
        states, _ = batched_reset(env, seed, b)
        torch.manual_seed(seed)
        policy = ActorCritic(env.config.policy_obs_length, hidden=hidden).to(dev)
        collect = build_fused_collect(env.config, t, hidden=hidden, deterministic=det)
        ks, ktraj = collect(states, policy, seed + 1)
        digest = hashlib.sha256()
        for k in sorted(ktraj):
            digest.update(ktraj[k].contiguous().view(torch.uint8).cpu().numpy().tobytes())
        digest.update(pack_state(ks).cpu().numpy().tobytes())
        emit({"tree": tree, "kernel": "fused_collect (K2a) digest of traj and state",
              "env": env_id, "B": b, "T": t, "deterministic": det, "widths": hidden,
              "overrides": overrides, "sha256": digest.hexdigest()})
        torch.cuda.empty_cache()


def gru_seq_kernels(tree, repeats, plain, emit, dev):
    """K11, K12 and K13 at the band shape, and K10's output digests (see the
    module's docstring)."""
    import hashlib

    import torch
    import chip_smoke
    from rware_tpu_torch.ops.fused_gru import (
        build_fused_gru_loss_bwd,
        build_fused_gru_obs_bwd,
        build_fused_gru_obs_fwd,
        build_fused_gru_seq_bwd,
        build_fused_gru_seq_fwd,
    )
    from rware_tpu_torch.testing import random_gru_seq_case

    b, t = 16384, 128
    band = ((b - 5 * 128) % b, b // 4)  # the first band of an epoch at row offset 5: it wraps
    dims, a = random_gru_seq_case("rware-tiny-2ag-v2", b, t, band, 37, dev)
    fwd, bwd = build_fused_gru_seq_fwd(dims), build_fused_gru_seq_bwd(dims)
    loss = build_fused_gru_loss_bwd(dims, 0.2, 0.5, 0.01)
    seq = (a["wh"], a["bhn"], a["iall"], a["done"], a["h0"])
    hseq = fwd(*seq, *band)
    gen = torch.Generator().manual_seed(41)
    dh = (torch.randn(hseq.shape, generator=gen) * 1e-2).to(torch.bfloat16).to(dev)
    largs = (a["wh"], a["bhn"], a["whead"], a["bhead"], a["iall"], a["done"], a["h0"], hseq,
             a["action"], a["logp"], a["value"], a["adv"], a["target"], a["stats"], *band)
    base = {"tree": tree, "env": "rware-tiny-2ag-v2", "B": b, "T": t, "band": band}
    for name, kernel, args in (("fused_gru_seq_fwd (K11)", fwd, seq + band),
                               ("fused_gru_seq_bwd (K12)", bwd, seq + (hseq, dh) + band),
                               ("fused_gru_loss_bwd (K13)", loss, largs)):
        med, lo, hi = time_launches(lambda: kernel(*args), repeats)
        rec = dict(base, kernel=name, ms_median=med, ms_min=lo, ms_max=hi,
                   sequence_steps_per_s=t * band[1] * hseq.shape[2] / med * 1e3)
        if plain:
            rec["plain_ms"] = time_launches(lambda: kernel.plain(*args), 1)[0]
        emit(rec)
        if kernel is not fwd and hasattr(kernel, "timed"):
            splits = [kernel.timed(*args)[-1] for _ in range(repeats + 1)][1:]
            emit(dict(base, kernel=f"{name} split, ms", **{
                k: statistics.median(s[k] for s in splits) for k in splits[0]}))
    del a, seq, hseq, dh, largs
    torch.cuda.empty_cache()
    # K10 on chip_smoke's phase-13 cases: a digest of its outputs' bits
    for env_id, bb, t_len, bands, hidden in chip_smoke.GRU_CASES:
        dims, weights, obs, done, h0 = chip_smoke.random_gru_case(env_id, bb, t_len, 17, dev,
                                                                  hidden=hidden)
        k9, k10 = build_fused_gru_obs_fwd(dims), build_fused_gru_obs_bwd(dims)
        for band in bands:
            hseq = k9(weights, obs, done, h0, *band)
            gen = torch.Generator().manual_seed(19)
            dh = (torch.randn(hseq.shape, generator=gen) * 1e-3).to(torch.bfloat16).to(dev)
            grads, dh0 = k10(weights, obs, done, h0, hseq, dh, *band)
            digest = hashlib.sha256()
            for x in (hseq, grads, dh0):
                digest.update(x.float().cpu().numpy().tobytes())
            emit({"tree": tree, "kernel": "fused_gru_obs_bwd (K10) digest of hseq, grads, dh0",
                  "env": env_id, "B": bb, "T": t_len, "band": band, "widths": hidden,
                  "sha256": digest.hexdigest()})


def seq_kernels(dims, weights, arrays, traj, carry, band, env_id, b, t, repeats, emit, dev,
                kernels):
    """K11, K12 and K13 on ``band`` of the collected trajectory: the gates of
    its observations, random cotangents for K12, random advantages and
    targets for K13's loss."""
    import torch

    from rware_tpu_torch.models.ippo_rnn import band_slice
    from rware_tpu_torch.models.networks import gru_embed_gates

    fwd, bwd, loss = kernels
    we, be, wi, bi, wh, bhn, wc, bc = (a.detach() for a in arrays)
    with torch.no_grad():
        iall = gru_embed_gates((we, be, wi, bi), band_slice(traj["obs"], *band).float())[1]
    iall = iall.to(torch.bfloat16)
    seq = (wh, bhn, iall, traj["done"], carry)
    hseq = fwd(*seq, *band)
    dh = (torch.randn(hseq.shape, device=dev) * 1e-2).to(torch.bfloat16)
    adv, target = torch.randn_like(traj["value"]), torch.randn_like(traj["value"])
    stats = torch.tensor([0.0, 1.0], device=dev)
    largs = (wh, bhn, wc, bc[0], iall, traj["done"], carry, hseq, traj["action"], traj["logp"],
             traj["value"], adv, target, stats, *band)
    for name, fn in (("fused_gru_seq_fwd", lambda: fwd(*seq, *band)),
                     ("fused_gru_seq_bwd", lambda: bwd(*seq, hseq, dh, *band)),
                     ("fused_gru_loss_bwd", lambda: loss(*largs))):
        med, lo, hi = time_launches(fn, repeats)
        emit({"kernel": name, "env": env_id, "B": b, "T": t, "band": band, "ms_median": med,
              "ms_min": lo, "ms_max": hi,
              "sequence_steps_per_s": t * band[1] * hseq.shape[2] / med * 1e3})


def library_gru(repeats, emit, dev):
    """``torch.nn.GRU`` in bf16 over T=128 steps of 8,192 sequences, 128 ->
    128, from a zero hidden: the library's recurrence, beside K9's."""
    import torch

    torch.manual_seed(0)
    gru = torch.nn.GRU(128, 128).to(device=dev, dtype=torch.bfloat16)
    x = torch.randn((128, 8192, 128), device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        med, lo, hi = time_launches(lambda: gru(x), repeats)
    emit({"kernel": "torch.nn.GRU bf16 (a yardstick, not K9's function)", "T": 128,
          "sequences": 8192, "input": 128, "hidden": 128, "ms_median": med, "ms_min": lo,
          "ms_max": hi, "cudnn": torch.backends.cudnn.version()})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="*", default=[
        "rware-tiny-2ag-v2", "rware-small-4ag-v2", "rware-medium-6ag-hard-v2",
        "rware-large-8ag-v2", "rware-tiny-16ag-v2"])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--train-step", action="store_true")
    ap.add_argument("--algo", choices=["ippo", "mappo", "seac-ppo"], default="ippo")
    ap.add_argument("--net", choices=["mlp", "gru"], default="mlp")
    ap.add_argument("--fused-critic-phase", action="store_true")
    ap.add_argument("--fused-loss", action="store_true",
                    help="--net gru: the loss-fused learner; every config times K11-K13")
    ap.add_argument("--msg-bits", type=int, default=0)
    ap.add_argument("--n-envs", type=int, default=16384)
    ap.add_argument("--env", default="rware-tiny-2ag-v2",
                    help="the train step's and the profile's env (image ids too)")
    ap.add_argument("--out")
    ap.add_argument("--ppo-kernels", action="store_true",
                    help="time only K3-K8 at the main shape on random data")
    ap.add_argument("--collect-kernels", action="store_true",
                    help="time only the collectors (K2a, K2b, K2e, K2d, K1, K2c, K2d′) at the "
                         "main shape; K2a's output digests")
    ap.add_argument("--gru-seq-kernels", action="store_true",
                    help="time only K11, K12 and K13 at the band shape; K10's output digests")
    ap.add_argument("--rollout-kernels", action="store_true",
                    help="time only K1 at its main shape on each of --configs, M=0 and M=2")
    ap.add_argument("--route", help="--rollout-kernels: force this route of K1's plan")
    ap.add_argument("--library-gru", action="store_true",
                    help="time only torch.nn.GRU in bf16 at K9's band shape")
    ap.add_argument("--tree", help="import rware_tpu_torch from this checkout")
    ap.add_argument("--plain", action="store_true",
                    help="--ppo-kernels, --collect-kernels, --gru-seq-kernels, "
                         "--rollout-kernels: time each plain version too")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    import rware_tpu_torch
    from rware_tpu_torch.models import ActorCritic
    from rware_tpu_torch.models.networks import GruDims, gru_to_arrays, init_recurrent_actor_critic
    from rware_tpu_torch.ops.fused_gru import (
        build_fused_gru_loss_bwd,
        build_fused_gru_obs_bwd,
        build_fused_gru_obs_fwd,
        build_fused_gru_seq_bwd,
        build_fused_gru_seq_fwd,
    )
    from rware_tpu_torch.ops.fused_rollout import (
        build_fused_collect,
        build_fused_collect_gru,
        build_fused_rollout,
    )
    from rware_tpu_torch.parallel import batched_reset

    dev = torch.device("cuda:0")
    device = {"kind": torch.cuda.get_device_name(0), "nvidia_smi": card()}
    lines = []

    m = args.msg_bits

    def emit(rec):
        if m:
            rec["msg_bits"] = m
        rec["device"] = device
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    if args.ppo_kernels:
        ppo_kernels(args.tree or ".", args.repeats, args.plain, emit, dev)
        args.configs = []
    if args.collect_kernels:
        collect_kernels(args.tree or ".", args.repeats, args.plain, emit, dev)
        args.configs = []
    if args.gru_seq_kernels:
        gru_seq_kernels(args.tree or ".", args.repeats, args.plain, emit, dev)
        args.configs = []
    if args.library_gru:
        library_gru(args.repeats, emit, dev)
        args.configs = []
    if args.rollout_kernels:
        rollout_kernels(args.tree or ".", args.configs, args.route, args.repeats, args.plain,
                        emit, dev)
        args.configs = []
    for env_id in args.configs:
        env = rware_tpu_torch.make(env_id, device=dev, msg_bits=m)
        b, t = 65536, 256
        states, _ = batched_reset(env, 0, b)
        roll = build_fused_rollout(env.config, t)
        med, lo, hi = time_launches(lambda: roll(states, 1), args.repeats)
        emit({"kernel": "fused_rollout", "env": env_id, "B": b, "T": t, "ms_median": med,
              "ms_min": lo, "ms_max": hi, "env_steps_per_s": b * t / med * 1e3})
        b, t = 16384, 128
        states, _ = batched_reset(env, 0, b)
        torch.manual_seed(0)
        policy = ActorCritic(env.config.policy_obs_length, msg_bits=m).to(dev)
        collect = build_fused_collect(env.config, t)
        med, lo, hi = time_launches(lambda: collect(states, policy, 1), args.repeats)
        emit({"kernel": "fused_collect", "env": env_id, "B": b, "T": t, "ms_median": med,
              "ms_min": lo, "ms_max": hi, "env_steps_per_s": b * t / med * 1e3})
        gru = init_recurrent_actor_critic(env.config.policy_obs_length, seed=0,
                                          msg_bits=m).to(dev)
        carry = gru.initialize_carry((b, env.n_agents))
        collect_gru = build_fused_collect_gru(env.config, t)
        med, lo, hi = time_launches(lambda: collect_gru(states, gru, 1, carry), args.repeats)
        emit({"kernel": "fused_collect_gru", "env": env_id, "B": b, "T": t, "ms_median": med,
              "ms_min": lo, "ms_max": hi, "env_steps_per_s": b * t / med * 1e3})
        _, _, traj = collect_gru(states, gru, 1, carry)
        gdims = GruDims.of(gru)
        weights = [w.detach() for w in gru_to_arrays(gru)[:6]]
        fwd, bwd = build_fused_gru_obs_fwd(gdims), build_fused_gru_obs_bwd(gdims)
        band = (b - b // 8, b // 4)  # a quarter of the envs, wrapping
        seq = (weights, traj["obs"], traj["done"], carry)
        hseq = fwd(*seq, *band)
        dh = (torch.randn(hseq.shape, device=dev) * 1e-3).to(torch.bfloat16)
        for name, fn in (("fused_gru_obs_fwd", lambda: fwd(*seq, *band)),
                         ("fused_gru_obs_bwd", lambda: bwd(*seq, hseq, dh, *band))):
            med, lo, hi = time_launches(fn, args.repeats)
            emit({"kernel": name, "env": env_id, "B": b, "T": t, "band": band, "ms_median": med,
                  "ms_min": lo, "ms_max": hi,
                  "sequence_steps_per_s": t * band[1] * env.n_agents / med * 1e3})
        if args.fused_loss:
            seq_kernels(gdims, weights, gru_to_arrays(gru), traj, carry, band, env_id, b, t,
                        args.repeats, emit, dev, (build_fused_gru_seq_fwd(gdims),
                                                  build_fused_gru_seq_bwd(gdims),
                                                  build_fused_gru_loss_bwd(gdims, 0.2, 0.5, 0.01)))
        del traj, hseq, dh, seq
        if m:
            ppo_message_head(env_id, b, m, args.repeats, emit, dev)
        if args.algo == "seac-ppo":
            seac_kernels(env, env_id, states, args.repeats, emit)

    if args.profile:
        env = rware_tpu_torch.make(args.env, device=dev)
        states, _ = batched_reset(env, 0, 65536)
        roll = build_fused_rollout(env.config, 256)
        top, busy, wall = profile(lambda: roll(states, 1))
        emit({"profile": "fused_rollout call", "device_ms_by_kernel": top,
              "device_busy_ms": busy, "wall_ms": wall})
        states, _ = batched_reset(env, 0, 16384)
        policy = ActorCritic(env.config.policy_obs_length).to(dev)
        collect = build_fused_collect(env.config, 128)
        top, busy, wall = profile(lambda: collect(states, policy, 1))
        emit({"profile": "fused_collect call", "device_ms_by_kernel": top,
              "device_busy_ms": busy, "wall_ms": wall})
    if args.train_step:
        from rware_tpu_torch.models import ippo
        from rware_tpu_torch.models.ippo_fused import build_fused_train_step

        env = rware_tpu_torch.make(args.env, device=dev, msg_bits=m)
        cfg = ippo.IPPOConfig(n_envs=args.n_envs, rollout_len=128, epochs=4, minibatches=4)
        if args.algo == "seac-ppo":
            from rware_tpu_torch.models import seac

            scfg = seac.SEACPPOConfig(n_envs=cfg.n_envs, rollout_len=cfg.rollout_len,
                                      epochs=cfg.epochs, minibatches=cfg.minibatches)
            if args.net == "gru":
                runner, dims = seac.init_seac_gru(env, scfg, 0)
                step = seac.build_seac_gru_train_step(env, dims, scfg)
                what = "recurrent seac-ppo (K2d′, cross replay by autograd per band)"
            elif m:
                runner, dims = seac.init_seac_ppo(env, scfg, 0)
                step = seac.build_seac_ppo_train_step(env, dims, scfg)
                what = "seac-ppo (K2d with K2b, flat update by autograd)"
            else:
                runner, dims = seac.init_seac_ppo(env, scfg, 0)
                step = seac.build_seac_ppo_fused_train_step(env, dims, scfg)
                what = "seac-ppo (K2d, K8 per pass)"
        elif args.net == "gru" and args.algo == "mappo":
            from rware_tpu_torch.models import mappo

            runner, dims, cdims = mappo.init_rnn_mappo_runner(env, cfg, 0)
            step = mappo.build_rnn_mappo_train_step(env, dims, cdims, cfg)
            what = "recurrent mappo (K2c, K6, K9 + K10 + critic-only K5 per band)"
        elif args.net == "gru":
            from rware_tpu_torch.models import ippo_rnn

            runner, dims = ippo_rnn.init_rnn_runner(env, cfg, 0)
            step = ippo_rnn.build_rnn_fused_train_step(env, dims, cfg, fused_loss=args.fused_loss)
            what = ("recurrent ippo, loss-fused (K2c, K11 + K13 per pass)" if args.fused_loss
                    else "recurrent ippo (K2c, K9 + K10 per pass)")
        elif args.algo == "mappo":
            from rware_tpu_torch.models import mappo

            runner, dims, cdims = mappo.init_mappo_runner(env, cfg, 0)
            step = mappo.build_mappo_train_step(env, dims, cdims, cfg,
                                                fused_critic_phase=args.fused_critic_phase)
            what = "mappo, " + ("whole phase (K7)" if args.fused_critic_phase else
                                "split path (K4 + critic autograd)" if m else "per pass (K5)")
        else:
            runner, dims = ippo.init_runner(env, cfg, 0)
            step = build_fused_train_step(env, dims, cfg)
            what = "fused, per pass (K4 with the message head)" if m else "fused"
        box = [runner]

        def update():
            box[0], _ = step(box[0])

        each = []
        med, lo, hi = time_launches(update, args.repeats, each)
        # the same updates timed as chip_smoke.py times them, twice
        b2b = [back_to_back_ms(update, 3) for _ in range(2)]
        steps = cfg.n_envs * cfg.rollout_len
        emit({"train_step": f"{what}, {args.env}", "B": cfg.n_envs, "T": cfg.rollout_len,
              "epochs": cfg.epochs, "minibatches": cfg.minibatches, "ms_median": med,
              "ms_min": lo, "ms_max": hi, "ms_each": each, "ms_back_to_back_of_3": b2b,
              "env_steps_per_s": steps / med * 1e3})
        top, busy, wall = profile(update)
        emit({"profile": f"{what} train step", "device_ms_by_kernel": top,
              "device_busy_ms": busy, "wall_ms": wall})
    emit({"nvidia_smi_after": card()})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
