#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU, and check it.

Phases, one line each:

1. the CUDA device, and its name and power limit from nvidia-smi;
2. build the kernels of ``rware_tpu_torch/csrc`` with nvcc for sm_90a;
3. the fused rollout kernel (K1) against its plain PyTorch version on the
   card, bit for bit: scripted and random mode on five configs at a batch
   that is not a multiple of 128, each route of its launch plan
   (``ops/fused_rollout.rollout_plan``: the compact env in shared memory, in
   device memory, and the scan route of the kernel before the shelf map) on
   tiny-2ag and large-8ag with two message bits, a uint16 shelf map
   (304 shelves) and a grid that no tile holds (8,192 cells, the scan route by
   the plan), and the plain version on the CPU (phase 5 holds the main-path
   shape);
4. the fused collector kernel (K2a) against its plain version on the card:
   deterministic and random mode on five configs and on tiny-2ag at hidden
   (24, 40) (multiples of 8 but not of 16: fewer 8 x 8 register tiles than
   threads); obs, rewards and done exact, value and logp within 2e-2, at
   least 99.9% of actions equal;
5. the main path at full size: ``make`` -> ``batched_reset`` ->
   ``build_fused_rollout`` (B=65,536, T=256, tiny-2ag) and
   ``build_fused_collect`` (B=16,384, T=128, hidden (128, 128)), timed with
   CUDA events beside the plain versions and held to them (K1's first
   chained launch bit for bit, K2a by phase 4's rules), with launch counters
   reset just before and read just after;
6. the fused PPO gradient kernel (K4) against its plain version on the card:
   random data on tiny-2ag, tiny-16ag and sensor ranges 3 and 5 (dense_0
   streamed through shared memory) at B=1000, and tiny-2ag at hidden (36, 20)
   (multiples of 4 but not of 16: the tensor-core tiles padded and the stores
   masked), windows that wrap; gradients within 1e-2 of each block's largest
   |plain|, metrics within rtol 1e-3; two launches bit-equal;
7. the whole-update-phase kernel (K3) against its plain version: E=4, M=4,
   B=4096; parameters within 0.05 * lr * P, moments within 2e-2 of each
   block's largest |plain|, metrics within rtol 1e-2; two launches
   bit-equal;
8. the training main path at full width through
   ``rware_tpu_torch.models.ippo_fused.build_fused_train_step``: tiny-2ag,
   B=16,384, T=128, E=4, M=4, hidden (128, 128), three updates after one
   warm-up with launch counters reset before and read after, the time of an
   update split into collect (K2a), GAE and last value, and update phase
   (K3), one update of the per-pass path (K4 and the optimizer), each PPO
   kernel timed and compared at that shape beside its plain version, and one
   more K3 launch split by CUDA events into the per-sample kernel, the weight
   gradients, their reduction and the Adam step;
9. the critic-values kernel (K6) and the MAPPO gradient kernel (K5, with and
   without the actor) against their plain versions: random data on tiny-2ag,
   small-4ag, sensor range 3 and tiny-16ag (whose critic dense_0 is streamed
   through shared memory) at B=1000, and tiny-2ag at hidden (36, 20), windows
   that wrap; values within 2e-2 (mean
   1e-4), gradients within 1e-2 of each block's largest |plain|, metrics
   within rtol 1e-3; the actor's local value head exactly zero; two launches
   bit-equal;
10. the whole-MAPPO-phase kernel (K7) against its plain version: E=4, M=4,
    B=4096, T=16; both parts' parameters within 0.05 * lr * P, moments within
    2e-2 of each block's largest |plain|, metrics within rtol 1e-2; two
    launches bit-equal;
11. the MAPPO training main path at full width through
    ``rware_tpu_torch.models.mappo.build_mappo_train_step`` on an env made
    with ``make``'s default device (the card): tiny-2ag, B=16,384, T=128,
    E=4, M=4, actor and critic hidden (128, 128), with ``fused_critic_phase``
    (K7) and without (K5 per pass), each three updates after one warm-up with
    launch counters reset before and read after; the time of an update split
    into collect (K2a), critic values (K6), GAE and bootstrap, and update
    phase; K5, K6 and K7 timed and compared at that shape beside their plain
    versions;
12. the recurrent collector kernel (K2c) against its plain version on the
    card, from a nonzero carry: deterministic and random mode on tiny-2ag,
    small-4ag and tiny-16ag at B=1000, tiny-2ag at (embed, hidden) (24, 40)
    (multiples of 8 but not of 16: fewer jobs than threads) at B=1 and 1000,
    and the main shape; obs, rewards, done and the final state exact, value
    and logp within 2e-2, at least 99.9% of actions equal and of carry
    entries within one bf16 step (7.8e-3);
13. the GRU sequence kernels (K9 forward, K10 backward) against their plain
    versions: random data with ``done`` at 20% and a nonzero initial hidden on
    tiny-2ag, sensor range 3 (351 features: like every width, the embed
    weights stream through shared memory) and tiny-16ag, env bands that wrap,
    tiny-2ag at embed 24 and hidden 40 (multiples of 8 but not of 16: the
    tensor-core tiles padded and masked), and the training shape, a 4,096-env
    band of B=16,384 at T=128 that wraps; each band's K9 tile and grid
    logged; ``hseq`` within one bf16 step on at least 99.9% of the entries and
    none past 8 steps, gradients and ``dh0`` within 1e-2 of each block's
    largest |plain|; two launches bit-equal;
14. the recurrent training main path at full width through
    ``rware_tpu_torch.models.ippo_rnn.build_rnn_fused_train_step`` on an env
    made with ``make``'s default device: tiny-2ag, B=16,384, T=128, E=4, M=4,
    embed 128, GRU hidden 128, three updates after one warm-up with launch
    counters reset before and read after (exactly 3 K2c, 48 K9, 48 K10); the
    time of an update split into collect (K2c), bootstrap and GAE, and the 16
    band passes; K2c, K9 and K10 timed and compared at that shape beside
    their plain versions, and one more K10 launch split into its prologue,
    sweep, epilogue and weight gradients by CUDA events;
15. the per-agent collector kernel (K2d) against its plain version on the
    card: deterministic and random mode on tiny-2ag (all agents' weights in
    shared memory), small-4ag and large-8ag (weights read from device memory)
    at B=1000, T=16, tiny-2ag at hidden (24, 40) on both routes (the device
    memory one forced) (phase 17 holds the main shape); obs, rewards, done
    and the final state exact, every action equal, value and logp within
    2e-2;
16. the SEAC-PPO gradient kernel (K8) against its plain version: random data
    on tiny-2ag (N=2) and small-4ag (N=4) at B=1000, and tiny-2ag at hidden
    (36, 20), windows that wrap, seac_lambda 1 and 0.5; every agent's
    gradients within 1e-2 of each block's
    largest |plain|, metrics within rtol 1e-3; two launches bit-equal;
17. the SEAC-PPO training main path at full width through
    ``rware_tpu_torch.models.seac.build_seac_ppo_fused_train_step`` on an env
    made with ``make``'s default device: tiny-2ag, B=16,384, T=128, E=4, M=4,
    hidden (128, 128), three updates after one warm-up with launch counters
    reset before and read after (exactly 3 K2d, 48 K8); the time of an update
    split into collect (K2d), cross values and GAE, and the 16 passes (K8 and
    the optimizer); K2d and K8 timed and compared at that shape beside their
    plain versions;
18. message bits (``msg_bits`` M > 0): K1 (scripted and random) and the
    collectors' message mode K2b in K2a and K2c (deterministic and random)
    against their plain versions on the card, on tiny-2ag M=2, small-4ag M=1
    and sensor range 2 M=3 at B=1000, T=16 (phase 20 holds K2a with K2b at the
    main shape), and K1 with messages at its main shape B=65,536, T=256, timed
    and its first launch held to its plain version; obs, rewards, done, the
    final state (messages included), bits and actions exact, value and logp
    within 2e-2;
19. the PPO gradient kernel with the message head (K4, M=2) against its plain
    version: tiny-2ag and tiny-16ag at B=1000, windows that wrap; gradients
    within 1e-2 of each block's largest |plain|, metrics within rtol 1e-3, two
    launches bit-equal;
20. the three learners with ``msg_bits=2`` at full width on an env made with
    ``make``'s default device: tiny-2ag, B=16,384, T=128, E=4, M=4, IPPO and
    MAPPO's split path with hidden (128, 128), recurrent IPPO with embed 128 +
    GRU 128; each three updates after one warm-up with launch counters reset
    before and read after (IPPO: 3 collector, 48 K4, 0 K3; recurrent: 3 K2c,
    48 K9, 48 K10; MAPPO: 3 collector, 48 K4, 0 K5, 0 K7), the time of an
    update split by phase; K2a with K2b (held to it) and K4 with the message
    head timed at that shape beside their plain versions; K2c with K2b held to its plain
    version at that shape and on tiny-2ag at (embed, hidden) (24, 40), B=1000;
21. the per-agent recurrent collector (K2d′) and its message mode (K2d′ with
    K2b) against their plain versions on the card: tiny-2ag, small-4ag and
    large-8ag, deterministic and random mode, M=0 and M=2 at B=1000, T=16
    from a nonzero carry (large-8ag M=2 also with the agents' bias and head
    blocks read from device memory; tiny-2ag at (embed, hidden) (24, 40) with
    them in shared and in device memory), then the main shape tiny-2ag B=16,384,
    T=128, embed 128, GRU 128 at M=0 and M=2; obs, rewards, done, bits,
    every action, the final state and the new carry exact, value and logp
    within 2e-2; the per-agent MLP collector's message mode (K2d with K2b) at
    M=2 on tiny-2ag (weights in shared memory) and large-8ag (in device
    memory), held the same way (phase 23 holds it at the main shape);
22. recurrent SEAC-PPO at full width through
    ``rware_tpu_torch.models.seac.build_seac_gru_train_step`` on an env made
    with ``make``'s default device: tiny-2ag, B=4,096, T=128, E=4, M=4,
    embed 128, GRU 128, at M=0 and M=2 message bits; three updates after one
    warm-up with launch counters reset before and read after (exactly 3
    K2d′); the time of an update split into collect (K2d′), the cross replay
    with bootstrap and cross GAE, and the 16 band passes; K2d′ timed and held
    to its plain version at that shape from the runner's state and carry;
23. SEAC-PPO with ``msg_bits=2`` through ``build_seac_ppo_train_step``
    (its kernel collector on the card): tiny-2ag, B=16,384, T=128, E=4, M=4, hidden (128,
    128); three updates after one warm-up (exactly 3 K2d with K2b launches,
    and no K8: the learner builds none), the time of an update split into
    collect, cross values with bootstrap and GAE, and the 16 flat minibatches;
    K2d with K2b timed at that shape beside its plain version and held to it
    by phase 21's rules;
24. image observations (K2e) in the four collectors against their plain
    versions on the card: K2a on img-tiny-2ag, imgdict-tiny-2ag,
    img-Nd-tiny-2ag, every image layer (AGENT_DIRECTION and AGENT_LOAD
    included) and img-tiny-2ag with M=2; K2c on the first three and every
    layer with M=2; K2d (weights in shared memory at tiny-2ag and small-4ag,
    in device memory at large-8ag) and K2d′ on img tiny-2ag, small-4ag and
    large-8ag, K2c and K2d′ on img-tiny-2ag at (embed, hidden) (24, 40) with
    M=0 and M=2, and K2d on img-tiny-2ag at hidden (24, 40) on both routes;
    B=1000, T=16, deterministic and random mode, from a nonzero carry; obs,
    rewards, done, bits, every action, the final state and the carry exact,
    value and logp within 2e-2;
25. the image main path at full width on ``rware-img-tiny-2ag-v2`` made with
    ``make``'s default device: IPPO (hidden (128, 128)) and recurrent IPPO
    (embed 128, GRU 128), B=16,384, T=128, E=4, M=4, each three updates after
    one warm-up with launch counters reset before and read after (exactly 3
    K2a-image + 3 K3 and no K4; 3 K2c-image + 48 K9 + 48 K10), the time of an
    update split by phase, and both image collectors timed at that shape
    beside their plain versions and held to them from the runner's state;
26. the iall-fed GRU kernels against their plain versions on the card: the
    sequence forward (K11), its backward (K12) and the loss-fused backward
    (K13) on tiny-2ag, sensor range 3 and tiny-16ag at B=1000 with bands that
    wrap, tiny-2ag and tiny-16ag also at embed 24 and hidden 40 (multiples of
    8 but not of 16: K12's and K13's tensor-core tiles padded and masked), and
    on a 4,096-env band of B=16,384, T=128 (embed 128, GRU 128), each with
    K11's tile S, grid and shared memory logged (``gru_seq_fwd_plan``);
    hseq within one bf16 step on 99.9% of the entries and 8 steps at most,
    gradients, d_iall and dh0 within 1e-2 of each block's largest |plain|,
    K13's metric sums within rtol 1e-3 (and 1e-5 of their means), two
    launches bit-equal; and ``GruSeqScan`` (K11 forward, K12 backward) under
    autograd on the wrapping tiny-2ag band against the same call on the plain
    versions: hseq as above, the gradients of wh, bhn, iall and h0 within
    1e-2 of each one's largest |plain|;
27. the loss-fused recurrent IPPO update (``fused_loss=True``) at full width:
    tiny-2ag, B=16,384, T=128, E=4, M=4, embed 128, GRU 128, three updates
    after one warm-up with launch counters reset before and read after
    (exactly 3 K2c, 48 K11, 48 K13 and no K9, K10 or K12: no learner calls
    the sequence backward, so any K12 wrapper's launch counts), the time of
    an update split by phase, and K11 (its tile and grid logged), K12 and K13
    timed at the band shape on the trajectory's data beside their plain
    versions and held to them, and
    one more K13 and K12 launch each split into its prologue, sweep, dWh and
    reduction by CUDA events (``FusedGruLossBwd.timed``);
28. recurrent MAPPO at the same shape with M=0 and M=2 message bits: three
    updates after one warm-up (exactly 3 K2c, 3 K6, 48 K9, 48 K10 and 48
    critic-only K5), the time of an update split by phase;
29. the Gym surface, which runs the torch engine and no kernel (JAX's adapter
    and vector env run XLA ops): the vector env (``gym.make_vec`` after the
    port's ``register_all``, or where gymnasium is not installed the device
    program it runs, ``core.host.HostVectorEnv``; a line says which) on
    tiny-2ag at B=4,096 for 128 steps of numpy-drawn actions with
    ``max_steps`` 100, its states, obs, rewards, done and info bit for bit
    those of ``Warehouse.step`` through ``debug.checked_step`` and a reset
    from the same generator state selected env by env (NEXT_STEP autoreset),
    obs in the observation space (or of the batch's size) on 4 sampled
    steps; the four observation types with two message bits at B=1,024; one
    env (``GymWarehouse``, or ``core.host.HostEnv``) on the card against the
    CPU on a golden delivery-free scenario of 15 scripted steps: obs,
    rewards, done, info, the rgb frames and global images byte for byte;
    exactly one device-to-host copy in a one-env step and in a vector step
    (torch.profiler), with the host-to-device copies, the device events and
    the device's busy time beside the profiled wall time; ``checked_step``'s
    ``throw()`` raising on two agents on one cell and on a carried shelf off
    its carrier; and the times, host conversion included: env-steps/s of the
    vector step at B=4,096 (FLATTENED and DICT), ms of a vector reset, steps/s
    of the one-env step.  ``check_invariants``, which phases 3-25 and 30 call,
    is ``debug.validate_state``;
30. SEAC A2C (``--algo seac``, rollouts of T=5): K2d against its plain
    version at that length on tiny-2ag at B=256 (deterministic and random)
    and 16,384, on small-4ag at B=4,096 and with K2b at M=2 on tiny-2ag at
    B=16,384 (obs, rewards, done, bits, the final state and every action
    exact, value and logp within 2e-2); ``build_seac_train_step`` on an env
    made with ``make``'s default device at those three shapes (hidden (128,
    128) per agent), three updates after one warm-up with the launch counter
    reset before and read after (exactly 3 K2d launches), every block of every
    agent moved, one update split into collect, the cross forwards with
    bootstrap, cross GAE and loss under autograd, and clip + Adam; the update
    on the card against the same update on the CPU from one K2d trajectory
    (loss terms within rtol 1e-4, every parameter within 0.05 lr); K2d timed at that shape beside its plain version; and
    ``train.main(["--algo", "seac", ..., "--profile-dir", DIR])`` at B=256
    and 16,384, 8 updates, its ``torch.profiler`` trace of updates 3-5 read
    back: CUDA kernels in it, exactly 3 of them K2d's, and the device's busy
    share of the traced window;
31. distribution (``rware_tpu_torch.distributed``, ``parallel.sharding``):
    (a) K1 (tiny-2ag, B=65,536, T=256) and K2a (B=16,384, T=128, hidden
    (128, 128)) launched on rows [8,192, 16,384) with ``env_offset=8192``
    equal the global launch's rows bit for bit, and their plain versions by
    phases 3-4's rules; K2c and K2d′ likewise at B=2,048, T=32; (b)
    ``initialize`` over NCCL at world size 1, then IPPO through the mesh at
    full width (tiny-2ag, B=16,384, T=128, E=4, M=4, hidden (128, 128), 3
    updates) bit for bit against the same learner without a mesh (per-pass
    K4), E * M + 1 all-reduces an update and none in the collect, ms per
    update of both, and the collectives' share of an update; (c) two gloo
    ranks on the one card (subprocesses that load the library built in phase
    2 and never build it): IPPO at a global B=16,384 (8,192 a rank) for 3
    updates, and recurrent IPPO (with and without the fused loss), MAPPO,
    recurrent MAPPO and recurrent SEAC-PPO at a global B=2,048, T=32 for one
    update each; each rank's first trajectory equal to its rows of the
    1-rank global collect, the parameters bit-equal across ranks and equal to
    an in-process emulation of the two ranks (``testing.emulate_mesh``) bit
    for bit (sha256 digests), the same collective counts; (d) ``python -m
    torch.distributed.run --nproc-per-node 1 -m rware_tpu_torch.train
    --distributed --mesh`` for 4 updates with a checkpoint every 2, then
    ``--resume`` to 6 (both launched beside (c), which times nothing), equal
    to an unbroken 6-update run's runner bit for bit;
32. the long-observation ids (sensor range 4 and 5, ``register_full``) on
    the collectors' new routes, each against its plain version by phases 4,
    15, 18, 21 and 24's rules (obs, rewards, done, bits, state and carry bit
    for bit) and two launches bit-equal: K2a with its weights in device
    memory on ``rware-5s-tiny-2ag-v2`` (L = 855) in both modes at B=1,000,
    T=32 (a ragged last tile) and at B=16,384, T=128, timed; with K2b on
    ``rware-4s-tiny-2ag-v2`` (M=2, L = 737) and with K2e on
    ``rware-img-5s-tiny-2ag-v2`` and ``rware-imgdict-5s-tiny-2ag-v2`` (B=1,000,
    T=32); K2d with its observation tile in chunks at 17 and 19 agents and
    K2d′ at 16, M=0 and M=2, B=1,024, T=128 at 17 and 16 agents with M=0 (the
    kernel line's cases) and T=32 for the others, and the chunked image
    instantiations (K2d′ on ``rware-img-5s-tiny-19ag-v2``, K2d on
    ``rware-imgdict-tiny-2ag-v2`` with chunks forced); then through the learners' entry points on
    ``make``'s default device, counters zeroed before and read after: three
    MAPPO updates (K2a + K6 + 16 x K5) at sensor range 5, B=16,384, T=128,
    E=4, M=4, with one update split into its phases, one IPPO update (K2a +
    K3) at that shape, one SEAC-PPO update (chunked K2d + 16 x K8) at 17
    agents, B=1,024, and one recurrent SEAC-PPO update (chunked K2d′) at 16
    agents, B=256.
33. the learners of JAX's ``collect_mode="xla"`` (``train --collect
    plain``), which run no kernel: MAPPO at B=16,384 and recurrent SEAC-PPO
    at B=4,096 (JAX's recurrent SEAC batch), T=128, E=4, M=4, hidden
    (128, 128) / embed and GRU 128, M=0 and M=2: a warm-up (one update of
    the same learner and batch at T=8), then two updates
    split into collect, values + GAE and passes, with every kernel launch
    counter zeroed before and read after and every call into the kernel
    library counted (none); ``check_invariants`` on the collected states;
    the plain collect's move, bit and reward frequencies within 5 sigma of
    the fused collector's (K2a, K2d′) from the same parameters, states and
    carry; the second half of the batch collected at ``env_offset`` = B/2
    equal to the global collect's rows in at least 99% of its envs, ``logp``
    within 1e-5 there (cuBLAS's products depend on the batch's shape: phase
    31c holds these two learners' ranks bit for bit to the emulated ranks
    instead); one pass of the update (E = M = 1, one optimizer step) on the
    first 512 (MAPPO) or 128 envs on the card against the CPU, from the
    card's trajectory and the same window: the loss terms within 1e-4
    relative (and 1e-5 absolute: pg_loss and approx_kl cancel to 1e-3) and
    every parameter within 0.05 lr (phase 30's bounds).

The MLP collector (K2a, with K2b and K2e; K2d) runs a tile of 64 envs a
block at the main shape: its env threads step, a thread a row builds the
observations from a view of the state in shared memory, and the hidden layers
are an FMA block product on the FP32 pipes, bit for bit the plain version's
sums (``ops/fused_rollout.collect_plan``); phases 4, 15, 18, 21, 24, 25 and
32 hold it to its plain version.  The recurrent collector (K2c, with K2b and
K2e; K2d′) runs the same way, its carry a tile in shared memory for the
whole launch and the embed and both gate products an FMA block product
(``ops/fused_rollout.collect_gru_plan``); phases 12, 14, 18, 20-22, 24, 25,
27, 28 and 32 hold it to its plain version or count its launches.

Away from the main shape, phases 3-24 run their comparisons for 16 steps
with episodes of 10 steps where they end episodes, so that every env ends one
and steps on from its reset (``BREADTH_T``).

Then the card's name and power limit, one JSON line describing each kernel
(its time beside its plain version's and beside ``bound_ms``, the least time
the card could take: the larger of the bytes the function must move once over
the memory rate and its operations over the peak rate of their type; no
single PyTorch call computes any of these functions, so ``library_ms`` is
null), and as the last line ``{"ok": true, "device": {...}}``.  Any failure raises
and the script exits non-zero without that line.

Usage: python3 chip_smoke.py
(``python3 chip_smoke.py --dp-rank SPEC RANK`` is phase 31's rank process.)
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

SCRIPT_START = time.perf_counter()

VALUE_LOGP_ATOL = 2e-2  # bf16 hidden layers; the same bound as the JAX tests
ACTION_AGREEMENT = 0.999
BF16_STEP = 2.0 ** -7  # one bf16 step of a hidden unit, |h| <= 1
K1_CONFIGS = (
    "rware-tiny-2ag-v2",
    "rware-small-4ag-v2",
    "rware-medium-6ag-hard-v2",
    "rware-large-8ag-v2",
    "rware-tiny-16ag-v2",
)
# The comparisons of phases 3-24 away from the main shape: B=1,000 envs for
# BREADTH_T steps with episodes of BREADTH_MAX_STEPS, so that every env ends
# one and steps on from its reset.  The plain versions take 15-30 ms a step
# whatever the batch, so these lengths set the script's time.
BREADTH_T, BREADTH_MAX_STEPS = 16, 10
# The largest per-env states (224 shelves; 16 agents with a queue of 16) spill
# to local memory in the kernels; they are covered here as well as tiny-2ag.
K2_CONFIGS = (
    ("rware-tiny-2ag-v2", {}),
    ("rware-small-4ag-v2", {"max_steps": BREADTH_MAX_STEPS}),
    ("rware-2s-tiny-2ag-v2", {"normalised_coordinates": True}),
    ("rware-large-8ag-v2", {"max_steps": BREADTH_MAX_STEPS}),
    ("rware-tiny-16ag-v2", {"max_steps": BREADTH_MAX_STEPS}),
)
# Sensor range 5 streams dense_0's weights through shared memory (too long to
# stay there); the others keep them resident.
K4_CONFIGS = ("rware-tiny-2ag-v2", "rware-tiny-16ag-v2", "rware-3s-tiny-2ag-v2",
              "rware-5s-tiny-2ag-v2")
VALUE_MEAN_ATOL = 1e-4  # K6: mean |value diff|; a bf16 step of a hidden unit is rare
GRAD_FRAC = 1e-2  # of each block's largest |plain gradient|
MOMENT_FRAC = 2e-2  # of each block's largest |plain moment|
K5_CONFIGS = ("rware-tiny-2ag-v2", "rware-small-4ag-v2", "rware-3s-tiny-2ag-v2",
              "rware-tiny-16ag-v2")
# Hidden widths that are multiples of 4 but not of 16: the PPO kernels'
# tensor-core tiles run padded and their stores masked (phases 6, 9, 16).
PADDED_CASE = ("rware-tiny-2ag-v2", (36, 20))
# Hidden widths that are multiples of 8 but not of 16: the collectors' 8 x 8
# register tiles cover them, with fewer jobs than threads (phases 4, 15, 24).
NARROW_CASE = ("rware-tiny-2ag-v2", (24, 40))
# tiny-2ag keeps every agent's weights in shared memory; from 4 agents on they
# are read from device memory
K2D_CONFIGS = (("rware-tiny-2ag-v2", {}),
               ("rware-small-4ag-v2", {"max_steps": BREADTH_MAX_STEPS}),
               ("rware-large-8ag-v2", {"max_steps": BREADTH_MAX_STEPS}))
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W).
PEAK_BYTES = 3.35e12  # device memory, bytes/s
PEAK_BF16 = 989e12  # tensor cores, FLOP/s on bf16 values
PEAK_F32 = 67e12  # FP32 FLOP/s outside the tensor cores
# The data sheet has no 32-bit integer rate, and a count of the env step's
# integer work would be a count of one algorithm, not of the function: integer
# work is charged nothing, so K1's bound is its bytes and K2a's the larger of
# its bytes and its policy's products.


def bound(n_bytes, bf16_flops=0.0, f32_flops=0.0):
    """(bound_ms, bound_by): the least time the card could take for work of
    ``n_bytes`` moved once and the given operations, and which of the two
    limits it."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = bf16_flops / PEAK_BF16 + f32_flops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def mlp_flops(k0, h1, h2, heads, samples, train):
    """(bf16 FLOPs, f32 FLOPs) of the two-hidden-layer MLP of the kernels on
    ``samples`` inputs of ``k0`` features: the hidden layers' products are on
    bf16 values, the ``heads`` columns in float32.  ``train`` adds the
    backward to the first hidden layer (dh2 = dcat Wc^T, dh1 = dz2 W1^T) and
    the three weight-gradient products."""
    hidden, head = k0 * h1 + h1 * h2, h2 * heads
    bf, f32 = hidden, head
    if train:
        bf += h1 * h2 + hidden
        f32 += 2 * head
    return 2.0 * samples * bf, 2.0 * samples * f32


def tensor_bytes(*tensors):
    return float(sum(t.numel() * t.element_size() for t in tensors))


def state_bytes(states):
    from rware_tpu_torch.core.state import state_field_names

    return tensor_bytes(*(getattr(states, f) for f in state_field_names()))


def ppo_bound(dims, cdims, data, t_mb, n_passes, whole_phase, with_actor=True):
    """``bound`` of the PPO kernels on the trajectory ``data``: ``n_passes``
    windows of ``t_mb`` rows for the actor ``dims`` (unless None or not
    ``with_actor``) and the critic ``cdims`` (unless None).  A gradient kernel
    reads its window once and moves parameters in and gradients out; a whole
    phase reads the whole trajectory once and moves parameters and both
    moments in and out."""
    t_full, b, n = data[1].shape
    rows = t_full if whole_phase else t_mb
    n_params = (dims.n_params if with_actor and dims is not None else 0) \
        + (cdims.n_params if cdims is not None else 0)
    n_bytes = tensor_bytes(*data) * rows / t_full + 4.0 * n_params * (6 if whole_phase else 2) \
        + 16.0 * n_passes
    bf = f32 = 0.0
    if with_actor and dims is not None:
        # MAPPO's actor has no value column in its loss; a message head adds M
        heads = dims.heads - (cdims is not None)
        a_bf, a_f32 = mlp_flops(dims.obs_len, dims.h1, dims.h2, heads, t_mb * b * n, True)
        bf, f32 = bf + a_bf, f32 + a_f32
    if cdims is not None:
        c_bf, c_f32 = mlp_flops(cdims.joint_len, cdims.h1, cdims.h2, n, t_mb * b, True)
        bf, f32 = bf + c_bf, f32 + c_f32
    return bound(n_bytes, n_passes * bf, n_passes * f32)


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bound_ms_by):
    """One entry of the ``kernels`` line.  ``library_ms`` is null: no single
    PyTorch call computes any of these functions."""
    return {"name": name, "route": "cuda", "source": f"rware_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms_by[0], "bound_by": bound_ms_by[1],
            "library_ms": None}


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


def tile_note(collect, b) -> str:
    """The tile a collector launch of ``b`` envs takes: envs and threads a
    block, and where the MLP's weights or the GRU's f32 bias and head blocks
    sit (the recurrent collectors plan per batch)."""
    plan = collect.plan(b) if callable(collect.plan) else collect.plan
    return (f"{plan.te} envs x {plan.threads} threads a block, "
            f"{'device' if plan.weights_global else 'shared'} memory")


def require(ok, msg: str) -> None:
    """Raise with ``msg`` unless ``ok`` (a check that ``python -O`` keeps)."""
    if not bool(ok):
        raise AssertionError(msg)


def check_invariants(env, state) -> None:
    """The engine's invariants on every env of ``state``, by
    ``rware_tpu_torch.debug``'s device check: agents and shelves in the grid,
    agents on distinct cells, shelves on distinct cells (K1's shelf map keeps
    one a cell), carried shelves in range, under their carriers and carried
    once, queues distinct and in range."""
    from rware_tpu_torch import debug

    debug.validate_state(state, env.config)


def oversize_config():
    """A 64 x 128 grid (8,192 cells) with 64 shelves and 4 agents: no tile of
    32 compact envs fits a block's shared memory, so K1's plan takes the scan
    route."""
    from rware_tpu_torch.config import WarehouseConfig

    h, w, n_shelves = 64, 128, 64
    grid = [["."] * w for _ in range(h)]
    for k in range(n_shelves):  # two racks of 32 slots
        grid[8 + k % 32][40 + 48 * (k // 32)] = "x"
    grid[h - 1][60] = grid[h - 1][61] = "g"
    return WarehouseConfig(layout="\n".join("".join(row) for row in grid), n_agents=4,
                           request_queue_size=8, max_steps=BREADTH_MAX_STEPS)


def compare_k1(env_id, dev, b, t, scripted, seed, route=None, config=None, **overrides):
    """K1 kernel vs its plain version on the card (with ``msg_bits`` in
    ``overrides``, scripted actions carry random bits; ``route`` forces one of
    the plan's routes; ``config`` replaces ``env_id``); returns (env, state,
    rewards, episodes, max |reward diff|)."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.core.env import Warehouse
    from rware_tpu_torch.ops.fused_rollout import build_fused_rollout
    from rware_tpu_torch.parallel import batched_reset

    env = (Warehouse(config, device=dev) if config is not None
           else rware_tpu_torch.make(env_id, device=dev, **overrides))
    states, _ = batched_reset(env, seed, b)
    roll = build_fused_rollout(env.config, t, scripted=scripted)
    roll.route = route
    actions = None
    if scripted:
        gen = torch.Generator(device=dev).manual_seed(seed)
        actions = torch.randint(0, 5, (t, b, env.n_agents), generator=gen, device=dev,
                                dtype=torch.int32)
        if env.config.msg_bits:
            bits = torch.randint(0, 2, (t, b, env.n_agents, env.config.msg_bits), generator=gen,
                                 device=dev, dtype=torch.int32)
            actions = torch.cat([actions[..., None], bits], dim=-1)
    ks, kr, ke = roll(states, seed + 1, actions)
    ps, pr, pe = roll.plain(states, seed + 1, actions)
    torch.cuda.synchronize()
    bad = state_diff(ks, ps)
    if bad or not torch.equal(kr, pr) or not torch.equal(ke, pe):
        raise AssertionError(
            f"K1 {env_id} route {roll.plan(b).route} scripted={scripted}: kernel != plain "
            f"(fields {bad}, "
            f"rewards equal {torch.equal(kr, pr)}, episodes equal {torch.equal(ke, pe)})"
        )
    check_invariants(env, ks)
    return env, ks, kr, ke, float((kr - pr).abs().max())


def compare_k2(env_id, dev, b, t, deterministic, seed, policy=None, hidden=(128, 128),
               **overrides):
    """K2a kernel vs its plain version on the card (a network of ``hidden``
    unless ``policy`` is given); returns the stats."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models import ActorCritic
    from rware_tpu_torch.ops.fused_rollout import build_fused_collect
    from rware_tpu_torch.parallel import batched_reset

    env = rware_tpu_torch.make(env_id, device=dev, **overrides)
    states, _ = batched_reset(env, seed, b)
    if policy is None:
        torch.manual_seed(seed)
        policy = ActorCritic(env.config.policy_obs_length, hidden=hidden).to(dev)
    collect = build_fused_collect(env.config, t, hidden=policy.hidden,
                                  deterministic=deterministic)
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


def check_blocks(dims, got, want, frac, what):
    """Each of the six blocks of ``got`` within ``frac`` of the largest
    |value| of ``want``'s block; returns the largest absolute difference."""
    for k, (g, w) in enumerate(zip(dims.split(got), dims.split(want))):
        err = float((g - w).abs().max())
        bound = frac * max(float(w.abs().max()), 1e-12)
        require(err <= bound, f"{what}: block {k} differs by {err} > {bound}")
    return float((got - want).abs().max())


def check_metric_sums(got, want, n, rtol, what):
    """The metrics of (..., 4) window sums over ``n`` samples within ``rtol``
    (and 1e-5: pg_loss is a mean of normalised advantages, near 0)."""
    import torch
    from rware_tpu_torch.ops.fused_update import metric_means

    g, w = metric_means(got, n), metric_means(want, n)
    for k in g:
        a, b = g[k].double(), w[k].double()
        ok = bool(((a - b).abs() <= rtol * b.abs() + 1e-5).all() and torch.isfinite(a).all())
        require(ok, f"{what}: metric {k} {a.tolist()} vs {b.tolist()}")


def compare_k4(env_id, dev, b, t_full, t_mb, starts, seed, hidden=(128, 128)):
    """K4 kernel vs plain at each window start; returns max |grad diff|."""
    import torch
    from rware_tpu_torch.ops.fused_update import build_fused_ppo_grads
    from rware_tpu_torch.testing import random_ppo_case

    dims, params, data = random_ppo_case(env_id, b, t_full, seed, dev, hidden=hidden)
    k4 = build_fused_ppo_grads(dims, t_mb, clip_eps=0.2, vf_coef=0.5, ent_coef=0.01)
    n = t_mb * b * data[1].shape[2]
    err = 0.0
    for start in starts:
        kg, ks = k4(params, data, start)
        kg2, ks2 = k4(params, data, start)
        pg, ps = k4.plain(params, data, start)
        torch.cuda.synchronize()
        require(torch.equal(kg, kg2) and torch.equal(ks, ks2),
                f"K4 {env_id} start {start}: two launches differ")
        err = max(err, check_blocks(dims, kg, pg, GRAD_FRAC, f"K4 {env_id} start {start}"))
        check_metric_sums(ks, ps, n, 1e-3, f"K4 {env_id} start {start}")
    return k4, err


def compare_k3(dev, b, t_full, epochs, minibatches, seed, data=None, dims=None, params=None):
    """K3 kernel vs plain on one update phase (random data, or ``data`` with
    ``dims`` and ``params``); returns (kernel ms, plain ms, max |param diff|)."""
    import torch
    from rware_tpu_torch.models import ippo
    from rware_tpu_torch.models.ippo_fused import phase_advstats, phase_window_starts
    from rware_tpu_torch.ops.fused_update import build_fused_ppo_update_phase
    from rware_tpu_torch.testing import random_ppo_case

    if data is None:
        dims, params, data = random_ppo_case("rware-tiny-2ag-v2", b, t_full, seed, dev)
    cfg = ippo.IPPOConfig(epochs=epochs, minibatches=minibatches)
    k3 = build_fused_ppo_update_phase(dims, t_full, epochs, minibatches, cfg.clip_eps,
                                      cfg.vf_coef, cfg.ent_coef, cfg.max_grad_norm)
    starts = phase_window_starts(cfg, t_full, k3.time_block,
                                 torch.Generator().manual_seed(seed)).to(dev)
    advstats = phase_advstats(data[4], starts, t_full // minibatches)
    p = epochs * minibatches
    hyper = ippo.adam_hyper(cfg, 0, p).to(dev)
    zero = torch.zeros_like(params)
    args = (params, zero, zero, data, starts, advstats, hyper)
    w, mu, nu, mets = k3(*args)
    k_ms, (w2, mu2, nu2, mets2) = cuda_ms(lambda: k3(*args))
    plain_ms, (pw, pmu, pnu, pmets) = cuda_ms(lambda: k3.plain(*args))
    require(all(torch.equal(a, c) for a, c in zip((w, mu, nu, mets), (w2, mu2, nu2, mets2))),
            "K3: two launches differ")
    err = float((w - pw).abs().max())
    require(err <= 0.05 * cfg.lr * p, f"K3: params differ by {err} > {0.05 * cfg.lr * p}")
    check_blocks(dims, mu, pmu, MOMENT_FRAC, "K3 mu")
    check_blocks(dims, nu, pnu, MOMENT_FRAC, "K3 nu")
    check_metric_sums(mets, pmets, t_full // minibatches * data[1].shape[1] * data[1].shape[2],
                      1e-2, "K3")
    return k_ms, plain_ms, err


def value_head_grad(dims, agrads):
    """The largest |gradient| of the actor's local value head (its column of
    the head block and its bias)."""
    blocks = dims.split(agrads)
    return max(float(blocks[4][:, dims.n_actions].abs().max()),
               float(blocks[5][0, dims.n_actions].abs()))


def compare_k6(dev, cdims, cparams, obs):
    """K6 kernel vs plain on ``obs``; returns (k6, max |value diff|)."""
    import torch
    from rware_tpu_torch.ops.fused_mappo import build_fused_critic_values

    k6 = build_fused_critic_values(cdims)
    kv = k6(cparams, obs)
    pv = k6.plain(cparams, obs)
    torch.cuda.synchronize()
    diff = (kv - pv).abs()
    err, mean = float(diff.max()), float(diff.mean())
    require(tuple(kv.shape) == tuple(obs.shape[:3]) and bool(torch.isfinite(kv).all()),
            "K6: wrong shape or non-finite values")
    require(err <= VALUE_LOGP_ATOL and mean <= VALUE_MEAN_ATOL,
            f"K6: values differ by max {err}, mean {mean}")
    return k6, err


def compare_k5(env_id, dev, b, t_full, t_mb, starts, seed, hidden=(128, 128)):
    """K6, and K5 with and without the actor, vs their plain versions at each
    window start; returns (k5, max |value diff|, max |grad diff|)."""
    import torch
    from rware_tpu_torch.ops.fused_mappo import build_fused_mappo_grads
    from rware_tpu_torch.testing import random_mappo_case

    dims, cdims, params, data = random_mappo_case(env_id, b, t_full, seed, dev, hidden=hidden)
    _, v_err = compare_k6(dev, cdims, params["critic"], data[0])
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01)
    k5 = build_fused_mappo_grads(dims, cdims, t_mb, **kw)
    k5c = build_fused_mappo_grads(None, cdims, t_mb, with_actor=False, **kw)
    cdata = (data[0], data[3], data[5])
    n = t_mb * b * cdims.n_agents
    err = 0.0
    for start in starts:
        what = f"K5 {env_id} start {start}"
        kg, ks = k5(params, data, start)
        kg2, ks2 = k5(params, data, start)
        pg, ps = k5.plain(params, data, start)
        cg, cs = k5c(params["critic"], cdata, start)
        cg2, cs2 = k5c(params["critic"], cdata, start)
        pcg, pcs = k5c.plain(params["critic"], cdata, start)
        torch.cuda.synchronize()
        same = all(torch.equal(kg[k], kg2[k]) for k in kg) and torch.equal(ks, ks2) \
            and torch.equal(cg, cg2) and torch.equal(cs, cs2)
        require(same, f"{what}: two launches differ")
        require(value_head_grad(dims, kg["actor"]) == 0.0 and
                value_head_grad(dims, pg["actor"]) == 0.0,
                f"{what}: the actor's local value head has a gradient")
        err = max(err, check_blocks(dims, kg["actor"], pg["actor"], GRAD_FRAC, what + " actor"),
                  check_blocks(cdims, kg["critic"], pg["critic"], GRAD_FRAC, what + " critic"),
                  check_blocks(cdims, cg, pcg, GRAD_FRAC, what + " critic only"))
        check_metric_sums(ks, ps, n, 1e-3, what)
        check_metric_sums(cs, pcs, n, 1e-3, what + " critic only")
        require(torch.equal(cg, kg["critic"]), f"{what}: critic-only gradient differs from the "
                "combined launch's")
    return k5, v_err, err


def compare_k7(dev, b, t_full, epochs, minibatches, seed, data=None, dims=None, cdims=None,
               params=None):
    """K7 kernel vs plain on one update phase (random data, or ``data`` with
    ``dims``, ``cdims`` and ``params``); returns (kernel ms, plain ms,
    max |param diff|)."""
    import torch
    from rware_tpu_torch.models import ippo
    from rware_tpu_torch.models.ippo_fused import phase_advstats, phase_window_starts
    from rware_tpu_torch.ops.fused_mappo import build_fused_mappo_update_phase
    from rware_tpu_torch.testing import random_mappo_case

    if data is None:
        dims, cdims, params, data = random_mappo_case("rware-tiny-2ag-v2", b, t_full, seed, dev)
    cfg = ippo.IPPOConfig(epochs=epochs, minibatches=minibatches)
    k7 = build_fused_mappo_update_phase(dims, cdims, t_full, epochs, minibatches, cfg.clip_eps,
                                        cfg.vf_coef, cfg.ent_coef, cfg.max_grad_norm)
    starts = phase_window_starts(cfg, t_full, k7.time_block,
                                 torch.Generator().manual_seed(seed)).to(dev)
    advstats = phase_advstats(data[4], starts, t_full // minibatches)
    p = epochs * minibatches
    hyper = ippo.adam_hyper(cfg, 0, p).to(dev)
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    args = (params, zero, zero, data, starts, advstats, hyper)
    w, mu, nu, mets = k7(*args)
    k_ms, (w2, mu2, nu2, mets2) = cuda_ms(lambda: k7(*args))
    plain_ms, (pw, pmu, pnu, pmets) = cuda_ms(lambda: k7.plain(*args))
    err = 0.0
    for part, d in (("actor", dims), ("critic", cdims)):
        same = all(torch.equal(a[part], c[part]) for a, c in ((w, w2), (mu, mu2), (nu, nu2)))
        require(same and torch.equal(mets, mets2), f"K7 {part}: two launches differ")
        perr = float((w[part] - pw[part]).abs().max())
        require(perr <= 0.05 * cfg.lr * p,
                f"K7 {part}: params differ by {perr} > {0.05 * cfg.lr * p}")
        require(float((w[part] - params[part]).abs().max()) > 0, f"K7 {part}: params did not move")
        check_blocks(d, mu[part], pmu[part], MOMENT_FRAC, f"K7 {part} mu")
        check_blocks(d, nu[part], pnu[part], MOMENT_FRAC, f"K7 {part} nu")
        err = max(err, perr)
    check_metric_sums(mets, pmets, t_full // minibatches * data[1].shape[1] * data[1].shape[2],
                      1e-2, "K7")
    return k_ms, plain_ms, err


def compare_k2c(env_id, dev, b, t, deterministic, seed, policy=None, hidden=(128, 128),
                **overrides):
    """K2c kernel vs its plain version on the card, from a nonzero carry;
    returns (env, state, new_h, traj, action agreement, value/logp error,
    share of carry entries within one bf16 step)."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models.networks import init_recurrent_actor_critic
    from rware_tpu_torch.ops.fused_rollout import build_fused_collect_gru
    from rware_tpu_torch.parallel import batched_reset

    env = rware_tpu_torch.make(env_id, device=dev, **overrides)
    states, _ = batched_reset(env, seed, b)
    gen = torch.Generator().manual_seed(seed)
    if policy is None:
        policy = init_recurrent_actor_critic(env.config.policy_obs_length, 5, hidden[1],
                                             hidden[0], seed).to(dev)
        with torch.no_grad():  # nonzero biases: a zero bias hides where it is rounded
            for p in policy.parameters():
                if p.dim() == 1:
                    p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    h0 = torch.rand((b, env.n_agents, hidden[1]), generator=gen) * 2 - 1
    h0 = h0.to(torch.bfloat16).to(dev)
    collect = build_fused_collect_gru(env.config, t, hidden, deterministic=deterministic)
    ks, kh, ktraj = collect(states, policy, seed + 1, h0)
    ps, ph, ptraj = collect.plain(states, policy, seed + 1, h0)
    torch.cuda.synchronize()
    what = f"K2c {env_id} deterministic={deterministic}"
    for k in ("obs", "reward", "done"):
        require(torch.equal(ktraj[k], ptraj[k]), f"{what}: {k} differs")
    bad = state_diff(ks, ps)
    require(not bad, f"{what}: final state differs in {bad}")
    agree = float((ktraj["action"] == ptraj["action"]).float().mean())
    err = max(float((ktraj[k] - ptraj[k]).abs().max()) for k in ("value", "logp"))
    h_ok = float(((kh.float() - ph.float()).abs() <= BF16_STEP).float().mean())
    require(agree >= ACTION_AGREEMENT and err <= VALUE_LOGP_ATOL and h_ok >= ACTION_AGREEMENT,
            f"{what}: action agreement {agree}, value/logp err {err}, carry within a bf16 step "
            f"{h_ok}")
    for k, v in ktraj.items():
        require(not v.is_floating_point() or bool(torch.isfinite(v.float()).all()),
                f"{what}: non-finite {k}")
    require(tuple(kh.shape) == tuple(h0.shape) and kh.dtype == torch.bfloat16,
            f"{what}: carry shape")
    last_done = ktraj["done"][-1]
    require(float(kh[last_done].float().abs().max()) == 0.0 if bool(last_done.any()) else True,
            f"{what}: the carry of an env whose episode just ended is not zero")
    check_invariants(env, ks)
    return env, ks, kh, ktraj, agree, err, h_ok


def random_gru_case(env_id, b, t_len, seed, dev, done_rate=0.2, hidden=(128, 128)):
    """(dims, weights, obs, done, h0) for the GRU sequence kernels: random
    weights with nonzero biases, 0/0.5/1 observations of the config's length,
    ``done`` at ``done_rate``, a nonzero carry."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models.networks import GruDims

    cfg = rware_tpu_torch.parse_env_id(env_id)
    dims = GruDims(cfg.policy_obs_length, hidden[0], hidden[1], 5)
    gen = torch.Generator().manual_seed(seed)
    weights = [(torch.randn(s, generator=gen) * (0.1 if s[0] == 1 else s[0] ** -0.5)).to(dev)
               for s in dims.shapes[:6]]
    obs = (torch.randint(0, 3, (t_len, b, cfg.n_agents, dims.obs_len), generator=gen) * 0.5)
    done = torch.rand((t_len, b), generator=gen) < done_rate
    h0 = torch.rand((b, cfg.n_agents, dims.hidden), generator=gen) * 2 - 1
    return (dims, weights, obs.to(torch.bfloat16).to(dev), done.to(dev),
            h0.to(torch.bfloat16).to(dev))


def compare_gru(dev, dims, weights, obs, done, h0, bands, seed, fwd=None, bwd=None, what="K9/K10"):
    """K9 and K10 kernels vs their plain versions on each band (start_env,
    n_env); returns (fwd, bwd, max |hseq diff|, max |grad diff|)."""
    import torch
    from rware_tpu_torch.ops.fused_gru import (
        build_fused_gru_obs_bwd,
        build_fused_gru_obs_fwd,
        gru_obs_fwd_plan,
    )

    fwd = fwd or build_fused_gru_obs_fwd(dims)
    bwd = bwd or build_fused_gru_obs_bwd(dims)
    h_err = g_err = 0.0
    for start, n_env in bands:
        tag = f"{what} band ({start}, {n_env})"
        plan = gru_obs_fwd_plan(dims, obs.shape[2], n_env)
        log(f"{tag}: K9 launches blocks of {plan.rows} sequences, grid {plan.blocks}")
        kh = fwd(weights, obs, done, h0, start, n_env)
        kh2 = fwd(weights, obs, done, h0, start, n_env)
        ph = fwd.plain(weights, obs, done, h0, start, n_env)
        torch.cuda.synchronize()
        require(torch.equal(kh, kh2), f"{tag}: two K9 launches differ")
        diff = (kh.float() - ph.float()).abs()
        require(bool(torch.isfinite(kh.float()).all()), f"{tag}: non-finite hseq")
        share = float((diff <= BF16_STEP).float().mean())
        require(share >= ACTION_AGREEMENT and float(diff.max()) <= 8 * BF16_STEP,
                f"{tag}: hseq within a bf16 step on {share}, max {float(diff.max())}")
        h_err = max(h_err, float(diff.max()))
        gen = torch.Generator().manual_seed(seed)
        dh = (torch.randn(ph.shape, generator=gen) * 1e-3).to(torch.bfloat16).to(dev)
        # both sides from the plain hseq, so that the comparison is of K10 alone
        kg, kd = bwd(weights, obs, done, h0, ph, dh, start, n_env)
        kg2, kd2 = bwd(weights, obs, done, h0, ph, dh, start, n_env)
        pg, pd = bwd.plain(weights, obs, done, h0, ph, dh, start, n_env)
        torch.cuda.synchronize()
        require(torch.equal(kg, kg2) and torch.equal(kd, kd2), f"{tag}: two K10 launches differ")
        for name, g, w in zip(("dWe", "dbe", "dWi", "dbi", "dWh", "dbhn"), bwd.split(kg),
                              bwd.split(pg)):
            err, top = float((g - w).abs().max()), max(float(w.abs().max()), 1e-12)
            require(err <= GRAD_FRAC * top, f"{tag}: {name} differs by {err} > {GRAD_FRAC} * {top}")
            g_err = max(g_err, err)
        err, top = float((kd - pd).abs().max()), max(float(pd.abs().max()), 1e-12)
        require(err <= GRAD_FRAC * top, f"{tag}: dh0 differs by {err} > {GRAD_FRAC} * {top}")
    return fwd, bwd, h_err, g_err


def compare_k2d(env_id, dev, b, t, deterministic, seed, policies=None, collect=None,
                states=None, hidden=(128, 128), weights_global=None, **overrides):
    """K2d kernel (with its message mode K2b where ``overrides`` give
    ``msg_bits``) vs its plain version on the card, from a reset unless
    ``states`` are given, each agent a network of ``hidden``, the weights in
    shared or device memory as the plan has it unless ``weights_global``
    says; returns (env, state, traj, value/logp error, collector)."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models.networks import init_actor_critic
    from rware_tpu_torch.models.seac import seac_policies_of
    from rware_tpu_torch.ops.fused_rollout import build_fused_collect_per_agent, collect_plan
    from rware_tpu_torch.parallel import batched_reset
    from rware_tpu_torch.testing import random_seac_case

    env = rware_tpu_torch.make(env_id, device=dev, **overrides)
    m = env.config.msg_bits
    if states is None:
        states, _ = batched_reset(env, seed, b)
    if policies is None and (m or tuple(hidden) != (128, 128)):
        # each agent its own network (with a message head), biases off zero
        gen = torch.Generator().manual_seed(seed)
        policies = torch.nn.ModuleList(
            init_actor_critic(env.config.policy_obs_length, 5, hidden, (seed, 2, i), m)
            for i in range(env.n_agents))
        with torch.no_grad():  # nonzero biases: a zero bias hides where it is rounded
            for p in policies.parameters():
                if p.dim() == 1:
                    p.copy_(0.3 * torch.randn(p.shape, generator=gen))
        policies = policies.to(dev)
    elif policies is None:  # each agent its own network, biases off zero
        dims, params, _ = random_seac_case(env_id, 1, 1, seed)
        policies = seac_policies_of(dims, params).to(dev)
    if collect is None:
        collect = build_fused_collect_per_agent(env.config, t, policies[0].hidden,
                                                deterministic=deterministic)
        if weights_global is not None:
            collect.plan = collect_plan(env.config, collect.hidden, env.n_agents,
                                        weights_global=weights_global)
    ks, ktraj = collect(states, policies, seed + 1)
    ps, ptraj = collect.plain(states, policies, seed + 1)
    torch.cuda.synchronize()
    what = f"K2d {env_id} M={m} deterministic={deterministic}"
    for k in ("obs", "reward", "done", "action") + (("bits",) if m else ()):
        require(torch.equal(ktraj[k], ptraj[k]), f"{what}: {k} differs")
    bad = state_diff(ks, ps)
    require(not bad, f"{what}: final state differs in {bad}")
    err = max(float((ktraj[k] - ptraj[k]).abs().max()) for k in ("value", "logp"))
    require(err <= VALUE_LOGP_ATOL, f"{what}: value/logp err {err}")
    for k, v in ktraj.items():
        require(not v.is_floating_point() or bool(torch.isfinite(v.float()).all()),
                f"{what}: non-finite {k}")
    check_invariants(env, ks)
    return env, ks, ktraj, err, collect


def compare_k8(env_id, dev, b, t_full, t_mb, starts, seed, seac_lambda, grads=None, data=None,
               dims=None, params=None, hidden=(128, 128)):
    """K8 kernel vs plain at each window start (random data at ``hidden``, or
    ``data`` with ``dims`` and ``params``); returns (k8, max |grad diff|)."""
    import torch
    from rware_tpu_torch.ops.fused_seac import build_fused_seac_grads
    from rware_tpu_torch.testing import random_seac_case

    if data is None:
        dims, params, data = random_seac_case(env_id, b, t_full, seed, dev, hidden=hidden)
    n_agents = params.shape[0]
    k8 = grads or build_fused_seac_grads(dims, n_agents, t_mb, clip_eps=0.2, vf_coef=0.5,
                                         ent_coef=0.01, seac_lambda=seac_lambda)
    n = t_mb * data[1].shape[1] * n_agents
    err = 0.0
    for start in starts:
        what = f"K8 {env_id} start {start} lambda {seac_lambda}"
        kg, ks = k8(params, data, start)
        kg2, ks2 = k8(params, data, start)
        pg, ps = k8.plain(params, data, start)
        torch.cuda.synchronize()
        require(torch.equal(kg, kg2) and torch.equal(ks, ks2), f"{what}: two launches differ")
        for i in range(n_agents):
            err = max(err, check_blocks(dims, kg[i], pg[i], GRAD_FRAC, f"{what} agent {i}"))
        check_metric_sums(ks, ps, n, 1e-3, what)
    return k8, err


MSG_CONFIGS = (("rware-tiny-2ag-v2", 2), ("rware-small-4ag-v2", 1), ("rware-2s-tiny-2ag-v2", 3))


def compare_k2b(env_id, dev, b, t, deterministic, seed, net="mlp", policy=None, collect=None,
                states=None, h0=None, hidden=(128, 128), **overrides):
    """The message mode K2b of the MLP (K2a) or recurrent (K2c) collector
    against its plain version on the card (``msg_bits`` in ``overrides``;
    from a reset and, for the GRU, a random nonzero carry unless ``states``
    and ``h0`` are given): obs, rewards, done, bits, actions, the final state
    and the new carry exact; returns (state, traj, collector, value/logp
    error)."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models.networks import init_actor_critic, init_recurrent_actor_critic
    from rware_tpu_torch.ops.fused_rollout import build_fused_collect, build_fused_collect_gru
    from rware_tpu_torch.parallel import batched_reset

    env = rware_tpu_torch.make(env_id, device=dev, **overrides)
    m, length = env.config.msg_bits, env.config.policy_obs_length
    if states is None:
        states, _ = batched_reset(env, seed, b)
    gen = torch.Generator().manual_seed(seed)
    if policy is None:
        init = init_actor_critic(length, 5, hidden, seed, m) if net == "mlp" else \
            init_recurrent_actor_critic(length, 5, hidden[1], hidden[0], seed, m)
        with torch.no_grad():  # nonzero biases: a zero bias hides where it is rounded
            for p in init.parameters():
                if p.dim() == 1:
                    p.copy_(0.3 * torch.randn(p.shape, generator=gen))
        policy = init.to(dev)
    what = f"K2b ({net}) {env_id} {overrides} deterministic={deterministic}"
    if net == "mlp":
        collect = collect or build_fused_collect(env.config, t, hidden, deterministic)
        ks, ktraj = collect(states, policy, seed + 1)
        ps, ptraj = collect.plain(states, policy, seed + 1)
    else:
        if h0 is None:
            h0 = torch.rand((b, env.n_agents, hidden[1]), generator=gen) * 2 - 1
            h0 = h0.to(torch.bfloat16).to(dev)
        collect = collect or build_fused_collect_gru(env.config, t, hidden, deterministic)
        ks, kh, ktraj = collect(states, policy, seed + 1, h0)
        ps, ph, ptraj = collect.plain(states, policy, seed + 1, h0)
        torch.cuda.synchronize()
        require(torch.equal(kh, ph), f"{what}: the new carry differs")
    torch.cuda.synchronize()
    for k in ("obs", "reward", "done", "action", "bits"):
        require(torch.equal(ktraj[k], ptraj[k]), f"{what}: {k} differs")
    bad = state_diff(ks, ps)
    require(not bad, f"{what}: final state differs in {bad}")
    err = max(float((ktraj[k] - ptraj[k]).abs().max()) for k in ("value", "logp"))
    require(err <= VALUE_LOGP_ATOL, f"{what}: value/logp err {err}")
    share = float(ktraj["bits"].float().mean())
    require(0.0 < share < 1.0, f"{what}: every bit is {share}")
    last = ktraj["bits"][-1].float() * (~ktraj["done"][-1]).float()[:, None, None]
    require(torch.equal(ks.agent_message, last), f"{what}: messages are not the last bits")
    for k, v in ktraj.items():
        require(not v.is_floating_point() or bool(torch.isfinite(v.float()).all()),
                f"{what}: non-finite {k}")
    check_invariants(env, ks)
    return ks, ktraj, collect, err


def compare_k4m(env_id, dev, b, t_full, t_mb, starts, seed, msg_bits=2, k4=None, dims=None,
                params=None, data=None):
    """K4 with the message head vs its plain version at each window start
    (random data, or ``data`` with ``dims``, ``params`` and ``k4``); returns
    (k4, max |grad diff|)."""
    import torch
    from rware_tpu_torch.ops.fused_update import build_fused_ppo_grads
    from rware_tpu_torch.testing import random_ppo_case

    if data is None:
        dims, params, data = random_ppo_case(env_id, b, t_full, seed, dev, msg_bits)
    k4 = k4 or build_fused_ppo_grads(dims, t_mb, clip_eps=0.2, vf_coef=0.5, ent_coef=0.01)
    n = t_mb * data[1].shape[1] * data[1].shape[2]
    err = 0.0
    for start in starts:
        what = f"K4 message head {env_id} start {start}"
        kg, ks = k4(params, data, start)
        kg2, ks2 = k4(params, data, start)
        pg, ps = k4.plain(params, data, start)
        torch.cuda.synchronize()
        require(torch.equal(kg, kg2) and torch.equal(ks, ks2), f"{what}: two launches differ")
        err = max(err, check_blocks(dims, kg, pg, GRAD_FRAC, what))
        check_metric_sums(ks, ps, n, 1e-3, what)
    return k4, err


def seac_bound(dims, data, t_mb):
    """``bound`` of K8 on one window of the trajectory ``data``: the window's
    rows read once (obs, actions and behaviour log-probs, and the three cross
    arrays), every agent's parameters in and gradients out; the products of
    K4's window (forward, backward, weight gradients) once per agent."""
    t_full, b, n = data[1].shape
    n_bytes = tensor_bytes(*data) * t_mb / t_full + 2 * 4.0 * n * dims.n_params + 24.0
    bf, f32 = mlp_flops(dims.obs_len, dims.h1, dims.h2, dims.n_actions + 1, t_mb * b * n, True)
    return bound(n_bytes, n * bf, n * f32)


def collect_per_agent_bound(dims, states, traj, params, agent_steps):
    """``bound`` of K2d (with K2b): the state in and out, the trajectory
    written, every agent's weights read, and the policy on every agent-step
    (integer work charged nothing, as for K2a)."""
    bf, f32 = mlp_flops(dims.obs_len, dims.h1, dims.h2, dims.heads, agent_steps, False)
    return bound(2 * state_bytes(states) + tensor_bytes(*traj.values())
                 + 4.0 * params.numel(), bf, f32)


def phase3(dev):
    """K1 against its plain version away from the main shape (phase 5 holds
    it at the main shape)."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.ops.fused_rollout import build_fused_rollout
    from rware_tpu_torch.parallel import batched_reset

    from rware_tpu_torch.ops.fused_rollout import ROLLOUT_ROUTES, rollout_plan

    for env_id in K1_CONFIGS:
        for scripted in (True, False):
            env, ks, kr, ke, _ = compare_k1(env_id, dev, 1000, BREADTH_T, scripted, 7,
                                            max_steps=BREADTH_MAX_STEPS)
            log(f"phase 3 K1 {env_id} B=1000 T={BREADTH_T} scripted={scripted}: bit-exact "
                f"(reward sum {float(kr.sum())}, episodes {int(ke.sum())}; route "
                f"{rollout_plan(env.config, 1000).route}, at B=65536 "
                f"{rollout_plan(env.config, 65536).route})")
    cases = [(env_id, route, 2, None) for route in ROLLOUT_ROUTES
             for env_id in ("rware-tiny-2ag-v2", "rware-large-8ag-v2")]
    cases += [("rware-4x5-4ag-v2", None, 0, None), ("8,192-cell grid", None, 0, oversize_config())]
    for env_id, route, m, config in cases:
        for scripted in (True, False):
            kw = {} if config is not None else {"max_steps": BREADTH_MAX_STEPS, "msg_bits": m}
            env, ks, kr, ke, _ = compare_k1(env_id, dev, 1000, BREADTH_T, scripted, 8,
                                            route=route,
                                            config=config, **kw)
            plan = rollout_plan(env.config, 1000, route)
            log(f"phase 3 K1 {env_id} M={m} route {plan.route} (map entries of "
                f"{plan.map_bytes} bytes) B=1000 T={BREADTH_T} scripted={scripted}: bit-exact "
                f"(reward sum {float(kr.sum())}, episodes {int(ke.sum())})")
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=dev)
    states, _ = batched_reset(env, 3, 256)
    roll = build_fused_rollout(env.config, 32)
    ks, kr, ke = roll(states, 5)
    cpu_s, cpu_r, cpu_e = roll.plain(states.map(lambda x: x.cpu()), 5)
    if state_diff(ks, cpu_s) or not torch.equal(kr.cpu(), cpu_r) or not torch.equal(ke.cpu(), cpu_e):
        raise AssertionError("K1 kernel on the card != plain version on the CPU")
    log("phase 3 K1 tiny-2ag B=256 T=32 random: the card == the plain version on the CPU")


def phase4(dev):
    """K2a against its plain version away from the main shape (phase 5 holds
    it at the main shape)."""
    for env_id, overrides in K2_CONFIGS:
        for deterministic in (True, False):
            _, _, traj, agree, err = compare_k2(env_id, dev, 1000, BREADTH_T, deterministic, 5,
                                                **overrides)
            log(f"phase 4 K2a {env_id} {overrides} B=1000 T={BREADTH_T} "
                f"deterministic={deterministic}: "
                f"obs/reward/done exact, actions {agree:.6f}, value/logp err {err}")
    for deterministic in (True, False):
        _, _, traj, agree, err = compare_k2(NARROW_CASE[0], dev, 1000, BREADTH_T, deterministic, 5,
                                            hidden=NARROW_CASE[1])
        log(f"phase 4 K2a {NARROW_CASE[0]} hidden {NARROW_CASE[1]} B=1000 T={BREADTH_T} "
            f"deterministic="
            f"{deterministic}: obs/reward/done exact, actions {agree:.6f}, value/logp err {err}")


def phase5(dev, kind, card):
    """The PR-1 main path (K1, K2a) at full size, each launch held to its
    plain version; returns their kernel entries."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models import ActorCritic
    from rware_tpu_torch.ops.fused_rollout import build_fused_collect, build_fused_rollout
    from rware_tpu_torch.parallel import batched_reset

    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=dev)
    b1, t1 = 65536, 256
    states, obs = batched_reset(env, 0, b1)
    rollout = build_fused_rollout(env.config, t1)
    rollout(states, 1)  # warm-up (first launch loads the module)
    b2, t2 = 16384, 128
    states2, _ = batched_reset(env, 2, b2)
    torch.manual_seed(0)
    policy = ActorCritic(env.config.policy_obs_length, hidden=(128, 128)).to(dev)
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
    # the plain versions on the first chained launch's inputs and on K2a's
    k1_plain_ms, (ps, pr, pe) = cuda_ms(lambda: rollout.plain(states, 5))
    k2_plain_ms, plain2 = cuda_ms(lambda: collect.plain(states2, policy, 5))
    ks, kr, ke = chain[1]
    if state_diff(ks, ps) or not torch.equal(kr, pr) or not torch.equal(ke, pe):
        raise AssertionError("K1 main shape: kernel != plain")
    k1_err = float((kr - pr).abs().max())
    k2_err = check_collect("K2a main shape", env, (fs2, traj), plain2, actions_exact=False)

    fs = chain[-1][0]
    rew = torch.stack([c[1] for c in chain[1:]]).sum(0)
    epis = torch.stack([c[2] for c in chain[1:]]).sum(0)
    if tuple(rew.shape) != (b1, 2) or not bool(torch.isfinite(rew).all()):
        raise AssertionError("fused rollout rewards: wrong shape or non-finite")
    if float(rew.sum()) <= 0 or int(epis.min()) < 2:
        raise AssertionError("fused rollout: no delivery, or an env ended < 2 episodes in 1024 steps")
    check_invariants(env, fs)
    want = {"obs": (t2, b2, 2, env.config.policy_obs_length), "action": (t2, b2, 2),
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
        f"{b1 * t1 / k1_ms * 1e3:.4g} env-steps/s (plain {k1_plain_ms:.1f} ms; the first "
        f"launch bit-exact against it, max_abs_err {k1_err}), "
        f"reward checksum {float(rew.sum())}, episodes {int(epis.sum())} [{kind}, {card}]")
    log(f"phase 5 main path K2a tiny-2ag B={b2} T={t2} hidden (128, 128): {k2_ms:.3f} ms/launch = "
        f"{b2 * t2 / k2_ms * 1e3:.4g} env-steps/s (plain {k2_plain_ms:.1f} ms; against it "
        f"obs/reward/done/state exact, value/logp max_abs_err {k2_err}), "
        f"reward checksum {float(traj['reward'].sum())}, launches {launches} [{kind}, {card}]")
    # K1 moves the state in and out and writes reward sums and counts.  K2a
    # also writes the trajectory and runs the policy on every agent.  The env
    # step's integer work and the Philox draws are charged nothing (see
    # ``bound``'s peaks), so both bounds are floors that no env step reaches.
    k1_bound = bound(2 * state_bytes(states) + tensor_bytes(chain[-1][1], chain[-1][2]))
    bf, f32 = mlp_flops(env.config.policy_obs_length, 128, 128, 6,
                        b2 * t2 * env.n_agents, False)
    k2_bound = bound(2 * state_bytes(states2) + tensor_bytes(*traj.values())
                     + tensor_bytes(*policy.parameters()), bf, f32)
    return [
        kernel_entry("fused_rollout", "fused_rollout.cu", "rware_tpu/ops/pallas_rollout.py:657",
                     launches["fused_rollout"], k1_err, k1_ms, k1_plain_ms, k1_bound),
        kernel_entry("fused_collect", "collect_mlp.cuh", "rware_tpu/ops/pallas_rollout.py:1798",
                     launches["fused_collect"], k2_err, k2_ms, k2_plain_ms, k2_bound),
    ]


def phase6(dev, kind, card):
    """K4 against its plain version on four observation lengths and agent
    counts, and at hidden (36, 20)."""
    for env_id, hidden in [(e, (128, 128)) for e in K4_CONFIGS] + [PADDED_CASE]:
        k4, err = compare_k4(env_id, dev, 1000, 8, 4, (0, 3, 7), seed=21, hidden=hidden)
        log(f"phase 6 K4 {env_id} hidden {hidden} B=1000 T=8 window 4 at starts 0, 3, 7: "
            f"within {GRAD_FRAC} of each block, max_abs_err {err}, two launches bit-equal "
            f"(tile {k4.tile}, dense_0 resident in shared memory {k4.w0_smem}) "
            f"[{kind}, {card}]")


def phase7(dev, kind, card):
    """K3 against its plain version."""
    k_ms, plain_ms, err = compare_k3(dev, 4096, 16, 4, 4, seed=31)
    log(f"phase 7 K3 tiny-2ag B=4096 T=16 E=4 M=4: params max_abs_err {err}, moments and "
        f"metrics within bounds, two launches bit-equal; {k_ms:.3f} ms (plain {plain_ms:.1f} ms) "
        f"[{kind}, {card}]")


def phase8(dev, kind, card, n_envs=16384, rollout_len=128):
    """The training main path at full width; returns the K4 and K3 entries."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models import ippo
    from rware_tpu_torch.models.ippo_fused import build_fused_train_step

    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=dev)
    cfg = ippo.IPPOConfig(n_envs=n_envs, rollout_len=rollout_len, epochs=4, minibatches=4)
    n_passes = cfg.epochs * cfg.minibatches
    runner, dims = ippo.init_runner(env, cfg, seed=0)
    step = build_fused_train_step(env, dims, cfg)
    runner, _ = step(runner)  # warm-up
    torch.cuda.synchronize()
    params0 = runner.params.clone()
    step.collect.launches = step.update_phase.launches = step.grads.launches = 0
    runs = []

    def update():
        nonlocal runner
        runner, metrics = step(runner)
        runs.append(metrics)

    update_ms, _ = cuda_ms(update, repeats=3)
    launches = {"fused_collect": step.collect.launches,
                "fused_ppo_update_phase": step.update_phase.launches}
    require(min(launches.values()) > 0, f"the train step launched no kernel: {launches}")
    for metrics in runs:
        for k, v in metrics.items():
            require(bool(torch.isfinite(v.float())), f"train step metric {k} is {float(v)}")
    moved = float((runner.params - params0).abs().max())
    require(moved > 0, "the train step did not move the parameters")
    rewards = [float(m["reward_per_env"]) for m in runs]
    require(sum(rewards) > 0, f"no reward in three updates: {rewards}")
    last = {k: round(float(v), 5) for k, v in runs[-1].items()}
    log(f"phase 8 train step tiny-2ag B={cfg.n_envs} T={cfg.rollout_len} E=4 M=4 hidden "
        f"(128, 128): {update_ms:.3f} ms/update = {cfg.n_envs * cfg.rollout_len / update_ms * 1e3:.4g} "
        f"env-steps/s over 3 updates, launches {launches}, params moved {moved}, "
        f"reward_per_env {rewards}, last metrics {last} [{kind}, {card}]")

    # The same update, phase by phase.
    collect_ms, (states, traj) = cuda_ms(lambda: step.rollout(runner))
    gae_ms, (obs, adv, targets) = cuda_ms(lambda: step.advantages(runner, states, traj))
    dataset = (traj["obs"], traj["action"], traj["logp"], traj["value"], adv, targets)
    phase_ms, _ = cuda_ms(lambda: step.update(runner, dataset))
    log(f"phase 8 breakdown of one update: collect (K2a) {collect_ms:.3f} ms, GAE and last value "
        f"{gae_ms:.3f} ms, update phase (K3, 16 passes) {phase_ms:.3f} ms [{kind}, {card}]")

    # The per-pass path: K4 and the optimizer step, one update.
    step4 = build_fused_train_step(env, dims, cfg, fused_update_phase=False)
    step4.grads.launches = 0
    per_pass_ms, (_, m4) = cuda_ms(lambda: step4(runner))
    k4_launches = step4.grads.launches
    require(k4_launches == n_passes, f"K4 launched {k4_launches} times")
    for k, v in m4.items():
        require(bool(torch.isfinite(v.float())), f"per-pass train step metric {k} is {float(v)}")
    per_pass_update_ms, _ = cuda_ms(lambda: step4.update(runner, dataset))
    log(f"phase 8 per-pass path (K4 + optimizer): {per_pass_ms:.3f} ms/update, of which the "
        f"update passes {per_pass_update_ms:.3f} ms; K4 launches {k4_launches} "
        f"[{kind}, {card}]")

    # Each PPO kernel at the main path's shapes, beside its plain version.
    k4 = step.grads
    k4(runner.params, dataset, 0)
    k4_ms, (kg, ks) = cuda_ms(lambda: k4(runner.params, dataset, 0), repeats=3)
    k4_plain_ms, (pg, ps) = cuda_ms(lambda: k4.plain(runner.params, dataset, 0))
    k4_err = check_blocks(dims, kg, pg, GRAD_FRAC, "K4 at the main shape")
    check_metric_sums(ks, ps, cfg.rollout_len // cfg.minibatches * cfg.n_envs * env.n_agents, 1e-3,
                      "K4 at the main shape")
    k3_ms, k3_plain_ms, k3_err = compare_k3(dev, cfg.n_envs, cfg.rollout_len, cfg.epochs,
                                            cfg.minibatches, 3, dataset, dims, runner.params)
    log(f"phase 8 kernels at the main shape: K4 {k4_ms:.3f} ms/launch (plain {k4_plain_ms:.1f} "
        f"ms, max_abs_err {k4_err}); K3 {k3_ms:.3f} ms/launch (plain {k3_plain_ms:.1f} ms, "
        f"params max_abs_err {k3_err}) [{kind}, {card}]")
    # one more K3 launch at that shape, each of its kernels between CUDA events
    from rware_tpu_torch.models.ippo_fused import phase_advstats, phase_window_starts

    k3 = step.update_phase
    starts = phase_window_starts(cfg, cfg.rollout_len, k3.time_block,
                                 torch.Generator().manual_seed(3)).to(dev)
    zero = torch.zeros_like(runner.params)
    args = (runner.params, zero, zero, dataset, starts,
            phase_advstats(dataset[4], starts, cfg.rollout_len // cfg.minibatches),
            ippo.adam_hyper(cfg, 0, n_passes).to(dev))
    total_ms, out = cuda_ms(lambda: k3.timed(*args))
    split = out[-1]
    log(f"phase 8 K3 split at the main shape, one timed launch, ms a pass: per-sample kernel "
        f"{split['sample']:.3f}, weight gradients {split['wgrad']:.3f}, their reduction and the "
        f"metric sums {split['reduce']:.3f}, the Adam step {split['adam']:.3f}; "
        f"{sum(split.values()) * n_passes:.3f} ms for {n_passes} passes, {total_ms:.3f} ms "
        f"around the call [{kind}, {card}]")
    t_mb = cfg.rollout_len // cfg.minibatches
    return [
        kernel_entry("fused_ppo_grads", "fused_ppo_grads.cu", "rware_tpu/ops/pallas_update.py:293",
                     k4_launches, k4_err, k4_ms, k4_plain_ms,
                     ppo_bound(dims, None, dataset, t_mb, 1, False)),
        kernel_entry("fused_ppo_update_phase", "fused_ppo_update.cu",
                     "rware_tpu/ops/pallas_update.py:901", launches["fused_ppo_update_phase"],
                     k3_err, k3_ms, k3_plain_ms,
                     ppo_bound(dims, None, dataset, t_mb, n_passes, True)),
    ]


def phase9(dev, kind, card):
    """K6 and K5 (with and without the actor) against their plain versions,
    and at hidden (36, 20)."""
    for env_id, hidden in [(e, (128, 128)) for e in K5_CONFIGS] + [PADDED_CASE]:
        k5, v_err, err = compare_k5(env_id, dev, 1000, 8, 4, (0, 3, 7), seed=21, hidden=hidden)
        log(f"phase 9 K6, K5 {env_id} hidden {hidden} B=1000 T=8 window 4 at starts 0, 3, 7: "
            f"values max_abs_err {v_err}; gradients (combined and critic-only) within "
            f"{GRAD_FRAC} of each block, max_abs_err {err}; the actor's value head exactly 0; "
            f"two launches bit-equal (critic tile {k5.tile}, its dense_0 resident in shared "
            f"memory {k5.w0_smem}) [{kind}, {card}]")


def phase10(dev, kind, card):
    """K7 against its plain version."""
    k_ms, plain_ms, err = compare_k7(dev, 4096, 16, 4, 4, seed=31)
    log(f"phase 10 K7 tiny-2ag B=4096 T=16 E=4 M=4: both parts' params max_abs_err {err}, "
        f"moments and metrics within bounds, two launches bit-equal; {k_ms:.3f} ms "
        f"(plain {plain_ms:.1f} ms) [{kind}, {card}]")


def phase11(dev, kind, card, n_envs=16384, rollout_len=128):
    """The MAPPO training main path at full width; returns the K5, K6 and K7
    entries."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models import ippo, mappo

    env = rware_tpu_torch.make("rware-tiny-2ag-v2")  # no device named: the card
    require(env.device.type == "cuda", f"make's default device is {env.device}")
    cfg = ippo.IPPOConfig(n_envs=n_envs, rollout_len=rollout_len, epochs=4, minibatches=4)
    n_passes = cfg.epochs * cfg.minibatches
    steps = cfg.n_envs * cfg.rollout_len
    runner0, dims, cdims = mappo.init_mappo_runner(env, cfg, seed=0)
    launches = {}
    for phase in (True, False):
        step = mappo.build_mappo_train_step(env, dims, cdims, cfg, fused_critic_phase=phase)
        runner, _ = step(runner0)  # warm-up
        torch.cuda.synchronize()
        params0 = {k: v.clone() for k, v in runner.params.items()}
        counted = {"fused_collect": step.collect, "fused_critic_values": step.critic_values,
                   "fused_mappo_update_phase" if phase else "fused_mappo_grads":
                   step.update_phase if phase else step.grads}
        for wrapper in counted.values():
            wrapper.launches = 0
        runs = []

        def update():
            nonlocal runner
            runner, metrics = step(runner)
            runs.append(metrics)

        update_ms, _ = cuda_ms(update, repeats=3)
        got = {k: w.launches for k, w in counted.items()}
        want = dict.fromkeys(got, 3)  # one collect, one K6, one K7 per update
        if not phase:
            want["fused_mappo_grads"] = 3 * n_passes
        require(got == want, f"three MAPPO updates launched {got}, not {want}")
        launches.update(got)
        for metrics in runs:
            for k, v in metrics.items():
                require(bool(torch.isfinite(v.float())), f"MAPPO metric {k} is {float(v)}")
        moved = {k: float((runner.params[k] - params0[k]).abs().max()) for k in params0}
        require(min(moved.values()) > 0, f"the MAPPO train step did not move a part: {moved}")
        require(value_head_grad(dims, runner.params["actor"] - runner0.params["actor"]) == 0.0,
                "the actor's local value head moved")
        rewards = [float(m["reward_per_env"]) for m in runs]
        require(sum(rewards) > 0, f"no reward in three MAPPO updates: {rewards}")
        last = {k: round(float(v), 5) for k, v in runs[-1].items()}
        log(f"phase 11 MAPPO train step tiny-2ag B={cfg.n_envs} T={cfg.rollout_len} E=4 M=4 "
            f"hidden (128, 128) fused_critic_phase={phase}: {update_ms:.3f} ms/update = "
            f"{steps / update_ms * 1e3:.4g} env-steps/s over 3 updates, launches {got}, params "
            f"moved {moved}, reward_per_env {rewards}, last metrics {last} [{kind}, {card}]")

        # The same update, phase by phase.
        collect_ms, (states, traj) = cuda_ms(lambda: step.rollout(runner))
        k6_ms, values = cuda_ms(lambda: step.values(runner, traj))
        gae_ms, (obs, adv, targets) = cuda_ms(
            lambda: step.advantages(runner, states, traj, values))
        dataset = (traj["obs"], traj["action"], traj["logp"], values, adv, targets)
        phase_ms, _ = cuda_ms(lambda: step.update(runner, dataset))
        log(f"phase 11 breakdown of one update (fused_critic_phase={phase}): collect (K2a) "
            f"{collect_ms:.3f} ms, critic values (K6) {k6_ms:.3f} ms, GAE and bootstrap "
            f"{gae_ms:.3f} ms, update phase ({'K7' if phase else 'K5 + optimizer'}, "
            f"{n_passes} passes) {phase_ms:.3f} ms [{kind}, {card}]")

    # Each MAPPO kernel at the main path's shapes, beside its plain version.
    params, t_mb = runner.params, cfg.rollout_len // cfg.minibatches
    k6 = step.critic_values
    k6_ms, kv = cuda_ms(lambda: k6(params["critic"], traj["obs"]), repeats=3)
    k6_plain_ms, _ = cuda_ms(lambda: k6.plain(params["critic"], traj["obs"]))
    _, k6_err = compare_k6(dev, cdims, params["critic"], traj["obs"])
    k5 = step.grads
    k5(params, dataset, 0)
    k5_ms, (kg, ks) = cuda_ms(lambda: k5(params, dataset, 0), repeats=3)
    k5_plain_ms, (pg, ps) = cuda_ms(lambda: k5.plain(params, dataset, 0))
    k5_err = max(check_blocks(dims, kg["actor"], pg["actor"], GRAD_FRAC, "K5 actor, main shape"),
                 check_blocks(cdims, kg["critic"], pg["critic"], GRAD_FRAC,
                              "K5 critic, main shape"))
    require(value_head_grad(dims, kg["actor"]) == 0.0, "K5: the value head has a gradient")
    check_metric_sums(ks, ps, t_mb * cfg.n_envs * env.n_agents, 1e-3, "K5 at the main shape")
    k7_ms, k7_plain_ms, k7_err = compare_k7(dev, cfg.n_envs, cfg.rollout_len, cfg.epochs,
                                            cfg.minibatches, 3, dataset, dims, cdims, params)
    log(f"phase 11 kernels at the main shape: K6 {k6_ms:.3f} ms/launch (plain {k6_plain_ms:.1f} "
        f"ms, max_abs_err {k6_err}); K5 {k5_ms:.3f} ms/launch (plain {k5_plain_ms:.1f} ms, "
        f"max_abs_err {k5_err}); K7 {k7_ms:.3f} ms/launch (plain {k7_plain_ms:.1f} ms, params "
        f"max_abs_err {k7_err}) [{kind}, {card}]")
    bf, f32 = mlp_flops(cdims.joint_len, cdims.h1, cdims.h2, cdims.n_agents, steps, False)
    k6_bound = bound(tensor_bytes(traj["obs"], kv) + 4.0 * cdims.n_params, bf, f32)
    return [
        kernel_entry("fused_mappo_grads", "fused_mappo_grads.cu",
                     "rware_tpu/ops/pallas_update.py:1498", launches["fused_mappo_grads"],
                     k5_err, k5_ms, k5_plain_ms, ppo_bound(dims, cdims, dataset, t_mb, 1, False)),
        kernel_entry("fused_critic_values", "fused_critic_values.cu",
                     "rware_tpu/ops/pallas_update.py:1759", launches["fused_critic_values"],
                     k6_err, k6_ms, k6_plain_ms, k6_bound),
        kernel_entry("fused_mappo_update_phase", "fused_mappo_update.cu",
                     "rware_tpu/ops/pallas_update.py:1852",
                     launches["fused_mappo_update_phase"], k7_err, k7_ms, k7_plain_ms,
                     ppo_bound(dims, cdims, dataset, t_mb, n_passes, True)),
    ]


K2C_CONFIGS = ("rware-tiny-2ag-v2", "rware-small-4ag-v2", "rware-tiny-16ag-v2")
# (env id, envs, steps, bands (first env, envs), (embed, hidden)): bands that
# wrap past the last env; (24, 40) are multiples of 8 but not of 16, so K10's
# tensor-core tiles run with padded, masked edges
GRU_CASES = (
    ("rware-tiny-2ag-v2", 1000, 8, ((0, 1000), (900, 500)), (128, 128)),
    ("rware-3s-tiny-2ag-v2", 300, 4, ((250, 100),), (128, 128)),
    ("rware-tiny-16ag-v2", 100, 4, ((60, 80),), (128, 128)),
    ("rware-tiny-2ag-v2", 1000, 8, ((900, 500),), (24, 40)),
    # the training shape: a 4,096-env band of B=16,384 that wraps
    ("rware-tiny-2ag-v2", 16384, 128, ((16384 - 2048, 4096),), (128, 128)),
)


def gru_cell_flops(dims, forward_only):
    """bf16 multiply-adds x 2 of one sequence-step of the GRU sequence kernels:
    the forward (embed, input gates, hidden gates) and, for the backward, the
    forward again plus dh, de and the three weight gradients."""
    e, hg = dims.embed, dims.hidden
    fwd = dims.obs_len * e + e * 3 * hg + hg * 3 * hg
    return 2.0 * (fwd if forward_only else 2 * fwd + hg * 3 * hg + e * 3 * hg)


def phase12(dev, kind, card):
    """K2c against its plain version; returns the main shape's max |error|."""
    for env_id in K2C_CONFIGS:
        for deterministic in (True, False):
            _, _, _, _, agree, err, h_ok = compare_k2c(env_id, dev, 1000, BREADTH_T,
                                                       deterministic, 5,
                                                       max_steps=BREADTH_MAX_STEPS)
            log(f"phase 12 K2c {env_id} max_steps={BREADTH_MAX_STEPS} B=1000 T={BREADTH_T} "
                f"deterministic={deterministic}: "
                f"obs/reward/done/state exact, actions {agree:.6f}, value/logp err {err}, carry "
                f"within a bf16 step {h_ok:.6f}")
    for b in (1, 1000):
        for deterministic in (True, False):
            _, _, _, _, agree, err, h_ok = compare_k2c(NARROW_CASE[0], dev, b, BREADTH_T,
                                                       deterministic, 5, hidden=NARROW_CASE[1],
                                                       max_steps=BREADTH_MAX_STEPS)
            log(f"phase 12 K2c {NARROW_CASE[0]} (embed, hidden) {NARROW_CASE[1]} B={b} "
                f"T={BREADTH_T} "
                f"deterministic={deterministic}: obs/reward/done/state exact, actions "
                f"{agree:.6f}, value/logp err {err}, carry within a bf16 step {h_ok:.6f}")
    _, _, _, _, agree, err, h_ok = compare_k2c("rware-tiny-2ag-v2", dev, 16384, 128, False, 13)
    log(f"phase 12 K2c main shape B=16384 T=128 random: obs/reward/done/state exact, actions "
        f"{agree:.6f}, value/logp max_abs_err {err}, carry within a bf16 step {h_ok:.6f} "
        f"[{kind}, {card}]")
    return err


def phase13(dev, kind, card):
    """K9 and K10 against their plain versions."""
    for env_id, b, t_len, bands, hidden in GRU_CASES:
        dims, weights, obs, done, h0 = random_gru_case(env_id, b, t_len, 17, dev, hidden=hidden)
        _, _, h_err, g_err = compare_gru(dev, dims, weights, obs, done, h0, bands, 19,
                                         what=f"K9/K10 {env_id} {hidden}")
        log(f"phase 13 K9, K10 {env_id} (L={dims.obs_len}, N={obs.shape[2]}, E={dims.embed}, "
            f"Hg={dims.hidden}) B={b} T={t_len} bands {bands}: hseq max_abs_err {h_err}, "
            f"gradients and dh0 within {GRAD_FRAC} of each block, max_abs_err {g_err}, two "
            f"launches bit-equal [{kind}, {card}]")


def phase14(dev, kind, card, k2c_err, n_envs=16384, rollout_len=128):
    """The recurrent training main path at full width; returns the K2c, K9
    and K10 entries."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models import ippo, ippo_rnn

    env = rware_tpu_torch.make("rware-tiny-2ag-v2")  # no device named: the card
    require(env.device.type == "cuda", f"make's default device is {env.device}")
    cfg = ippo.IPPOConfig(n_envs=n_envs, rollout_len=rollout_len, epochs=4, minibatches=4)
    n_passes, steps = cfg.epochs * cfg.minibatches, cfg.n_envs * cfg.rollout_len
    runner, dims = ippo_rnn.init_rnn_runner(env, cfg, seed=0)
    step = ippo_rnn.build_rnn_fused_train_step(env, dims, cfg)
    runner, _ = step(runner)  # warm-up
    torch.cuda.synchronize()
    params0 = runner.params.clone()
    counted = {"fused_collect_gru": step.collect, "fused_gru_obs_fwd": step.gru_fwd,
               "fused_gru_obs_bwd": step.gru_bwd}
    for wrapper in counted.values():
        wrapper.launches = 0
    runs = []

    def update():
        nonlocal runner
        runner, metrics = step(runner)
        runs.append(metrics)

    update_ms, _ = cuda_ms(update, repeats=3)
    launches = {k: w.launches for k, w in counted.items()}
    want = {"fused_collect_gru": 3, "fused_gru_obs_fwd": 3 * n_passes,
            "fused_gru_obs_bwd": 3 * n_passes}
    require(launches == want, f"three recurrent updates launched {launches}, not {want}")
    for metrics in runs:
        for k, v in metrics.items():
            require(bool(torch.isfinite(v.float())), f"recurrent metric {k} is {float(v)}")
    moved = [float((a - b).abs().max())
             for a, b in zip(dims.split(runner.params), dims.split(params0))]
    require(min(moved) > 0, f"the recurrent train step left a block unmoved: {moved}")
    rewards = [float(m["reward_per_env"]) for m in runs]
    require(sum(rewards) > 0, f"no reward in three recurrent updates: {rewards}")
    require(tuple(runner.carry.shape) == (n_envs, env.n_agents, dims.hidden)
            and bool(torch.isfinite(runner.carry.float()).all()), "the carry is off")
    last = {k: round(float(v), 5) for k, v in runs[-1].items()}
    log(f"phase 14 recurrent train step tiny-2ag B={cfg.n_envs} T={cfg.rollout_len} E=4 M=4 "
        f"embed {dims.embed} hidden {dims.hidden}: {update_ms:.3f} ms/update = "
        f"{steps / update_ms * 1e3:.4g} env-steps/s over 3 updates, launches {launches}, params "
        f"moved {max(moved)}, reward_per_env {rewards}, last metrics {last} [{kind}, {card}]")

    # The same update, phase by phase.
    collect_ms, (states, new_carry, traj) = cuda_ms(lambda: step.rollout(runner))
    gae_ms, (obs, adv, targets) = cuda_ms(
        lambda: step.advantages(runner, states, new_carry, traj))
    dataset = (traj["obs"], traj["done"], traj["action"], traj["logp"], traj["value"], adv,
               targets, runner.carry)
    passes_ms, _ = cuda_ms(lambda: step.update(runner, dataset))
    log(f"phase 14 breakdown of one update: collect (K2c) {collect_ms:.3f} ms, bootstrap and GAE "
        f"{gae_ms:.3f} ms, {n_passes} band passes (K9 + loss + K10 + optimizer) {passes_ms:.3f} "
        f"ms [{kind}, {card}]")

    # Each kernel at the main path's shapes, beside its plain version.
    policy = ippo_rnn.rnn_policy_of(dims, runner.params)
    k2c = step.collect
    args = (runner.env_states, policy, 7, runner.carry)
    k2c_ms, _ = cuda_ms(lambda: k2c(*args), repeats=2)
    k2c_plain_ms, _ = cuda_ms(lambda: k2c.plain(*args))
    weights = dims.split(runner.params)[:6]
    n_env, starts = ippo_rnn.epoch_band_starts(cfg, 5)
    band = (starts[0], n_env)  # rows 27..31 and 0..2: a band that wraps
    seq = (weights, traj["obs"], traj["done"], runner.carry)
    fwd, bwd = step.gru_fwd, step.gru_bwd
    k9_ms, hseq = cuda_ms(lambda: fwd(*seq, *band), repeats=3)
    k9_plain_ms, _ = cuda_ms(lambda: fwd.plain(*seq, *band))
    dh = (torch.randn(hseq.shape, device=dev) * 1e-3).to(torch.bfloat16)
    k10_ms, (grads, dh0) = cuda_ms(lambda: bwd(*seq, hseq, dh, *band), repeats=3)
    k10_plain_ms, _ = cuda_ms(lambda: bwd.plain(*seq, hseq, dh, *band))
    _, _, k9_err, k10_err = compare_gru(dev, dims, *seq, (band,), 23, fwd, bwd,
                                        what="K9/K10 at the main shape")
    log(f"phase 14 kernels at the main shape: K2c {k2c_ms:.3f} ms/launch (plain "
        f"{k2c_plain_ms:.1f} ms, value/logp max_abs_err {k2c_err}); K9 {k9_ms:.3f} ms/launch "
        f"(plain {k9_plain_ms:.1f} ms, hseq max_abs_err {k9_err}); K10 {k10_ms:.3f} ms/launch "
        f"(plain {k10_plain_ms:.1f} ms, max_abs_err {k10_err}), band {band} [{kind}, {card}]")
    # one more K10 launch, each of its kernels between CUDA events
    total_ms, (_, _, split) = cuda_ms(lambda: bwd.timed(*seq, hseq, dh, *band))
    log(f"phase 14 K10 split at the main shape, one timed launch: prologue "
        f"{split['prologue']:.3f} ms, sweep {split['sweep']:.3f} ms, epilogue "
        f"{split['epilogue']:.3f} ms, weight gradients and reduction {split['wgrad']:.3f} ms; "
        f"{sum(split.values()):.3f} ms together, {total_ms:.3f} ms around the call "
        f"[{kind}, {card}]")

    # Bounds.  K2c moves the state and the carry in and out, writes the
    # trajectory and runs the cell on every agent-step (the env step's integer
    # work is charged nothing, as for K2a).  K9 reads its band's obs, done and
    # initial hidden and writes hseq; K10 also reads hseq and its cotangent and
    # writes the gradients and dh0.
    agent_steps = float(steps * env.n_agents)
    n_w = 4.0 * sum(r * c for r, c in dims.shapes[:6])
    k2c_bound = bound(2 * state_bytes(states) + tensor_bytes(*traj.values())
                      + 2 * tensor_bytes(runner.carry) + 4.0 * dims.n_params,
                      agent_steps * gru_cell_flops(dims, True),
                      agent_steps * 2.0 * dims.hidden * (dims.n_actions + 1))
    share = n_env / cfg.n_envs
    seq_steps = float(rollout_len * n_env * env.n_agents)
    seq_in = share * tensor_bytes(traj["obs"], traj["done"], runner.carry) + n_w / 2
    k9_bound = bound(seq_in + tensor_bytes(hseq), seq_steps * gru_cell_flops(dims, True))
    k10_bound = bound(seq_in + 2 * tensor_bytes(hseq) + n_w + tensor_bytes(dh0),
                      seq_steps * gru_cell_flops(dims, False))
    return [
        kernel_entry("fused_collect_gru", "collect_gru.cuh",
                     "rware_tpu/ops/pallas_rollout.py:1798", launches["fused_collect_gru"],
                     k2c_err, k2c_ms, k2c_plain_ms, k2c_bound),
        kernel_entry("fused_gru_obs_fwd", "fused_gru_fwd.cu", "rware_tpu/ops/pallas_gru.py:385",
                     launches["fused_gru_obs_fwd"], k9_err, k9_ms, k9_plain_ms, k9_bound),
        kernel_entry("fused_gru_obs_bwd", "fused_gru_bwd.cu", "rware_tpu/ops/pallas_gru.py:547",
                     launches["fused_gru_obs_bwd"], k10_err, k10_ms, k10_plain_ms, k10_bound),
    ]


def phase15(dev, kind, card):
    """K2d against its plain version away from the main shape (phase 17 holds
    it at the main shape)."""
    for env_id, overrides in K2D_CONFIGS:
        for deterministic in (True, False):
            _, _, _, err, collect = compare_k2d(env_id, dev, 1000, BREADTH_T, deterministic, 5,
                                                **overrides)
            log(f"phase 15 K2d {env_id} {overrides} B=1000 T={BREADTH_T} "
                f"deterministic={deterministic}: "
                f"obs/reward/done/state/actions exact, value/logp err {err} (weights "
                f"{'in device memory' if collect.weights_global else 'in shared memory'}, "
                f"{collect.threads} threads)")
    for weights_global in (False, True):
        for deterministic in (True, False):
            _, _, _, err, collect = compare_k2d(NARROW_CASE[0], dev, 1000, BREADTH_T,
                                                deterministic, 5,
                                                hidden=NARROW_CASE[1],
                                                weights_global=weights_global)
            log(f"phase 15 K2d {NARROW_CASE[0]} hidden {NARROW_CASE[1]} B=1000 T={BREADTH_T} "
                f"deterministic={deterministic}: obs/reward/done/state/actions exact, value/logp "
                f"err {err} (weights {'in device' if weights_global else 'in shared'} memory, "
                f"{collect.threads} threads)")


def phase16(dev, kind, card):
    """K8 against its plain version on two agent counts, and at hidden (36, 20)."""
    for env_id, seac_lambda, hidden in (("rware-tiny-2ag-v2", 1.0, (128, 128)),
                                        ("rware-small-4ag-v2", 0.5, (128, 128)),
                                        (*PADDED_CASE[:1], 0.5, PADDED_CASE[1])):
        k8, err = compare_k8(env_id, dev, 1000, 8, 4, (0, 3, 7), 21, seac_lambda, hidden=hidden)
        log(f"phase 16 K8 {env_id} hidden {hidden} seac_lambda {seac_lambda} B=1000 T=8 window "
            f"4 at starts 0, 3, 7: every agent within {GRAD_FRAC} of each block, max_abs_err "
            f"{err}, metrics within rtol 1e-3, two launches bit-equal (tile {k8.tile}) "
            f"[{kind}, {card}]")


def phase17(dev, kind, card, n_envs=16384, rollout_len=128):
    """The SEAC-PPO training main path at full width; returns the K2d and K8
    entries."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models import seac

    env = rware_tpu_torch.make("rware-tiny-2ag-v2")  # no device named: the card
    require(env.device.type == "cuda", f"make's default device is {env.device}")
    cfg = seac.SEACPPOConfig(n_envs=n_envs, rollout_len=rollout_len, epochs=4, minibatches=4)
    n_passes, steps = cfg.epochs * cfg.minibatches, cfg.n_envs * cfg.rollout_len
    t_mb = cfg.rollout_len // cfg.minibatches
    runner, dims = seac.init_seac_ppo(env, cfg, seed=0)
    step = seac.build_seac_ppo_fused_train_step(env, dims, cfg)
    runner, _ = step(runner)  # warm-up
    torch.cuda.synchronize()
    params0 = runner.params.clone()
    counted = {"fused_collect_per_agent": step.collect, "fused_seac_grads": step.grads}
    for wrapper in counted.values():
        wrapper.launches = 0
    runs = []

    def update():
        nonlocal runner
        runner, metrics = step(runner)
        runs.append(metrics)

    update_ms, _ = cuda_ms(update, repeats=3)
    launches = {k: w.launches for k, w in counted.items()}
    want = {"fused_collect_per_agent": 3, "fused_seac_grads": 3 * n_passes}
    require(launches == want, f"three SEAC-PPO updates launched {launches}, not {want}")
    for metrics in runs:
        for k, v in metrics.items():
            require(bool(torch.isfinite(v.float())), f"SEAC-PPO metric {k} is {float(v)}")
    moved = [float((a - b).abs().max()) for i in range(env.n_agents)
             for a, b in zip(dims.split(runner.params[i]), dims.split(params0[i]))]
    require(min(moved) > 0, f"the SEAC-PPO train step left a block unmoved: {moved}")
    rewards = [float(m["reward_per_env"]) for m in runs]
    require(sum(rewards) > 0, f"no reward in three SEAC-PPO updates: {rewards}")
    last = {k: round(float(v), 5) for k, v in runs[-1].items()}
    log(f"phase 17 SEAC-PPO train step tiny-2ag B={cfg.n_envs} T={cfg.rollout_len} E=4 M=4 "
        f"hidden (128, 128): {update_ms:.3f} ms/update = {steps / update_ms * 1e3:.4g} "
        f"env-steps/s over 3 updates, launches {launches}, params moved {max(moved)}, "
        f"reward_per_env {rewards}, last metrics {last} [{kind}, {card}]")

    # The same update, phase by phase.
    collect_ms, (states, traj) = cuda_ms(lambda: step.rollout(runner))
    adv_ms, (obs, values, adv, targets) = cuda_ms(lambda: step.advantages(runner, states, traj))
    dataset = (traj["obs"], traj["action"], traj["logp"], values, adv, targets)
    passes_ms, _ = cuda_ms(lambda: step.update(runner, dataset))
    log(f"phase 17 breakdown of one update: collect (K2d) {collect_ms:.3f} ms, cross values, "
        f"bootstrap and cross GAE {adv_ms:.3f} ms, {n_passes} passes (K8 + optimizer) "
        f"{passes_ms:.3f} ms [{kind}, {card}]")

    # Each kernel at the main path's shapes, beside its plain version.
    policies = seac.seac_policies_of(dims, runner.params)
    k2d = step.collect
    args = (runner.env_states, policies, 7)
    k2d_ms, k2d_plain_ms, k2d_err, _ = route_check("K2d main shape", env, k2d, args)
    k8 = step.grads
    k8_ms, _ = cuda_ms(lambda: k8(runner.params, dataset, 0), repeats=3)
    k8_plain_ms, _ = cuda_ms(lambda: k8.plain(runner.params, dataset, 0))
    _, k8_err = compare_k8("rware-tiny-2ag-v2", dev, 0, 0, t_mb, (0, 112), 0, cfg.seac_lambda,
                           k8, dataset, dims, runner.params)
    log(f"phase 17 kernels at the main shape: K2d {k2d_ms:.3f} ms/launch (plain "
        f"{k2d_plain_ms:.1f} ms, value/logp max_abs_err {k2d_err}); K8 {k8_ms:.3f} ms/launch "
        f"(plain {k8_plain_ms:.1f} ms, max_abs_err {k8_err}) [{kind}, {card}]")

    k2d_bound = collect_per_agent_bound(dims, states, traj, runner.params, steps * env.n_agents)
    return [
        kernel_entry("fused_collect_per_agent", "collect_mlp.cuh",
                     "rware_tpu/ops/pallas_rollout.py:1798", launches["fused_collect_per_agent"],
                     k2d_err, k2d_ms, k2d_plain_ms, k2d_bound),
        kernel_entry("fused_seac_grads", "fused_seac_grads.cu",
                     "rware_tpu/ops/pallas_update.py:719", launches["fused_seac_grads"], k8_err,
                     k8_ms, k8_plain_ms, seac_bound(dims, dataset, t_mb)),
    ]


def phase18(dev, kind, card):
    """K1 with messages and K2b in both collectors against their plain
    versions; returns the K1 message-mode entry."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.ops.fused_rollout import build_fused_rollout
    from rware_tpu_torch.parallel import batched_reset

    for env_id, m in MSG_CONFIGS:
        for scripted in (True, False):
            _, _, kr, ke, _ = compare_k1(env_id, dev, 1000, BREADTH_T, scripted, 7, msg_bits=m,
                                         max_steps=BREADTH_MAX_STEPS)
            log(f"phase 18 K1 {env_id} M={m} B=1000 T={BREADTH_T} scripted={scripted}: bit-exact, "
                f"messages included (reward sum {float(kr.sum())}, episodes {int(ke.sum())})")
        for net in ("mlp", "gru"):
            for deterministic in (True, False):
                _, traj, collect, err = compare_k2b(env_id, dev, 1000, BREADTH_T,
                                                    deterministic, 5, net,
                                                    msg_bits=m, max_steps=BREADTH_MAX_STEPS)
                log(f"phase 18 K2b ({net}) {env_id} M={m} B=1000 T={BREADTH_T} deterministic="
                    f"{deterministic}: obs/reward/done/bits/actions/state exact, value/logp err "
                    f"{err}, bits set {float(traj['bits'].float().mean()):.4f} "
                    f"({tile_note(collect, 1000)})")

    # K1 with messages at its main shape: chained launches from one reset,
    # counted from just before to just after.
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=dev, msg_bits=2)
    b1, t1 = 65536, 256
    states, _ = batched_reset(env, 0, b1)
    roll = build_fused_rollout(env.config, t1)
    roll(states, 1)  # warm-up
    roll.launches = 0
    chain = [(states, None, None)]
    k1_ms, _ = cuda_ms(lambda: chain.append(roll(chain[-1][0], 4 + len(chain))), repeats=4)
    launches = roll.launches
    require(launches == 4, f"K1 with messages launched {launches} times, not 4")
    k1_plain_ms, (ps, pr, pe) = cuda_ms(lambda: roll.plain(states, 5))  # the first launch's
    ks, kr, ke = chain[1]
    require(not state_diff(ks, ps) and torch.equal(kr, pr) and torch.equal(ke, pe),
            "K1 with messages at the main shape: kernel != plain")
    k1_err = float((kr - pr).abs().max())
    final = chain[-1][0]
    share = float(final.agent_message.mean())
    require(abs(share - 0.5) < 0.01, f"K1 random message bits set {share}, not one half")
    check_invariants(env, final)
    log(f"phase 18 K1 with messages tiny-2ag M=2 B={b1} T={t1}: {k1_ms:.3f} ms/launch = "
        f"{b1 * t1 / k1_ms * 1e3:.4g} env-steps/s (plain {k1_plain_ms:.1f} ms), the first "
        f"launch bit-exact against it (messages included), message bits set {share:.4f}, launches {launches} [{kind}, {card}]")
    k1_bound = bound(2 * state_bytes(states) + tensor_bytes(chain[-1][1], chain[-1][2]))
    return kernel_entry("fused_rollout (message bits)", "fused_rollout.cu",
                        "rware_tpu/ops/pallas_rollout.py:657", launches, k1_err, k1_ms,
                        k1_plain_ms, k1_bound)


def phase19(dev, kind, card):
    """K4 with the message head against its plain version."""
    for env_id in ("rware-tiny-2ag-v2", "rware-tiny-16ag-v2"):
        k4, err = compare_k4m(env_id, dev, 1000, 8, 4, (0, 3, 7), 21)
        log(f"phase 19 K4 with the message head {env_id} M=2 B=1000 T=8 window 4 at starts 0, "
            f"3, 7: within {GRAD_FRAC} of each block, max_abs_err {err}, metrics within rtol "
            f"1e-3, two launches bit-equal (tile {k4.tile}, head rows {k4.hc}) [{kind}, {card}]")


def _time_learner(name, step, runner, counted, want, kind, card, cfg, phase=20,
                  need_reward=True):
    """Three updates after a warm-up with ``counted`` launch counters reset
    before and read after (they must equal ``want``), their metrics finite
    and, with ``need_reward``, some reward among them; returns (runner, ms
    per update)."""
    import torch
    from rware_tpu_torch.registry import SIZES

    runner, _ = step(runner)  # warm-up
    torch.cuda.synchronize()
    for wrapper in counted.values():
        wrapper.launches = 0
    runs = []

    def update():
        nonlocal runner
        runner, metrics = step(runner)
        runs.append(metrics)

    update_ms, _ = cuda_ms(update, repeats=3)
    got = {k: w.launches for k, w in counted.items()}
    require(got == want, f"three {name} updates launched {got}, not {want}")
    for metrics in runs:
        for k, v in metrics.items():
            require(bool(torch.isfinite(v.float())), f"{name} metric {k} is {float(v)}")
    rewards = [float(m["reward_per_env"]) for m in runs]
    require(not need_reward or sum(rewards) > 0, f"no reward in three {name} updates: {rewards}")
    last = {k: round(float(v), 5) for k, v in runs[-1].items()}
    steps = cfg.n_envs * cfg.rollout_len
    passes = f" E={cfg.epochs} M={cfg.minibatches}" if hasattr(cfg, "epochs") else ""
    env = step.env.config
    size = {v: k for k, v in SIZES.items()}.get((env.shelf_rows, env.shelf_columns),
                                                f"{env.shelf_rows}x{env.shelf_columns}")
    if env.sensor_range != 1:
        size = f"{env.sensor_range}s-{size}"
    log(f"phase {phase} {name} train step {size}-{env.n_agents}ag, {env.msg_bits} message bits, "
        f"B={cfg.n_envs} T={cfg.rollout_len}{passes}: {update_ms:.3f} ms/update = "
        f"{steps / update_ms * 1e3:.4g} env-steps/s over 3 updates, "
        f"launches {got}, reward_per_env {rewards}, last metrics {last} [{kind}, {card}]")
    return runner, update_ms


def phase20(dev, kind, card, n_envs=16384, rollout_len=128):
    """The three learners with message bits at full width; returns the K2b
    entries of both collectors and K4's message-mode entry."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models import ippo, ippo_rnn, mappo
    from rware_tpu_torch.models.ippo_fused import build_fused_train_step

    env = rware_tpu_torch.make("rware-tiny-2ag-v2", msg_bits=2)  # no device named: the card
    require(env.device.type == "cuda", f"make's default device is {env.device}")
    cfg = ippo.IPPOConfig(n_envs=n_envs, rollout_len=rollout_len, epochs=4, minibatches=4)
    n_passes, steps = cfg.epochs * cfg.minibatches, cfg.n_envs * cfg.rollout_len
    t_mb = cfg.rollout_len // cfg.minibatches

    # IPPO: K2a with K2b, then per pass K4 with the message head (no K3).
    runner, dims = ippo.init_runner(env, cfg, seed=0)
    step = build_fused_train_step(env, dims, cfg)
    require(step.update_phase is None, "IPPO with message bits built the K3 phase")
    runner, ippo_ms = _time_learner(
        "IPPO", step, runner, {"fused_collect": step.collect, "fused_ppo_grads": step.grads},
        {"fused_collect": 3, "fused_ppo_grads": 3 * n_passes}, kind, card, cfg)
    collect_launches, k4_launches = step.collect.launches, step.grads.launches
    collect_ms, (states, traj) = cuda_ms(lambda: step.rollout(runner))
    gae_ms, (obs, adv, targets) = cuda_ms(lambda: step.advantages(runner, states, traj))
    dataset = (traj["obs"], traj["action"], traj["logp"], traj["value"], adv, targets,
               traj["bits"])
    passes_ms, _ = cuda_ms(lambda: step.update(runner, dataset))
    log(f"phase 20 IPPO breakdown of one update: collect (K2a with K2b) {collect_ms:.3f} ms, GAE "
        f"and last value {gae_ms:.3f} ms, {n_passes} passes (K4 with the message head + "
        f"optimizer) {passes_ms:.3f} ms [{kind}, {card}]")
    policy = ippo.policy_of(dims, runner.params)
    k2b = step.collect
    k2b_ms, k2b_plain_ms, k2b_err, _ = route_check("K2a with K2b main shape", env, k2b,
                                                   (runner.env_states, policy, 7))
    k4 = step.grads
    k4_ms, _ = cuda_ms(lambda: k4(runner.params, dataset, 0), repeats=3)
    k4_plain_ms, _ = cuda_ms(lambda: k4.plain(runner.params, dataset, 0))
    _, k4_err = compare_k4m("rware-tiny-2ag-v2", dev, 0, 0, t_mb, (0, 112), 0, k4=k4, dims=dims,
                            params=runner.params, data=dataset)
    log(f"phase 20 kernels at the main shape: K2a with K2b {k2b_ms:.3f} ms/launch (plain "
        f"{k2b_plain_ms:.1f} ms, value/logp max_abs_err {k2b_err}); K4 with the message head "
        f"{k4_ms:.3f} ms/launch (plain {k4_plain_ms:.1f} ms, max_abs_err {k4_err}) "
        f"[{kind}, {card}]")
    bf, f32 = mlp_flops(dims.obs_len, dims.h1, dims.h2, dims.heads, steps * env.n_agents, False)
    k2b_bound = bound(2 * state_bytes(states) + tensor_bytes(*traj.values())
                      + 4.0 * dims.n_params, bf, f32)
    entries = [
        kernel_entry("fused_collect (message bits, K2b)", "collect_mlp.cuh",
                     "rware_tpu/ops/pallas_rollout.py:1537", collect_launches, k2b_err, k2b_ms,
                     k2b_plain_ms, k2b_bound),
        kernel_entry("fused_ppo_grads (message head)", "fused_ppo_grads.cu",
                     "rware_tpu/ops/pallas_update.py:293", k4_launches, k4_err, k4_ms,
                     k4_plain_ms, ppo_bound(dims, None, dataset, t_mb, 1, False)),
    ]

    # Recurrent IPPO: K2c with K2b, per band pass K9, the heads and loss, K10.
    runner, gdims = ippo_rnn.init_rnn_runner(env, cfg, seed=0)
    step = ippo_rnn.build_rnn_fused_train_step(env, gdims, cfg)
    runner, _ = _time_learner(
        "recurrent IPPO", step, runner,
        {"fused_collect_gru": step.collect, "fused_gru_obs_fwd": step.gru_fwd,
         "fused_gru_obs_bwd": step.gru_bwd},
        {"fused_collect_gru": 3, "fused_gru_obs_fwd": 3 * n_passes,
         "fused_gru_obs_bwd": 3 * n_passes}, kind, card, cfg)
    k2c_launches = step.collect.launches
    collect_ms, (states, new_carry, traj) = cuda_ms(lambda: step.rollout(runner))
    gae_ms, (obs, adv, targets) = cuda_ms(
        lambda: step.advantages(runner, states, new_carry, traj))
    dataset = (traj["obs"], traj["done"], traj["action"], traj["logp"], traj["value"], adv,
               targets, runner.carry, traj["bits"])
    passes_ms, _ = cuda_ms(lambda: step.update(runner, dataset))
    log(f"phase 20 recurrent IPPO breakdown of one update: collect (K2c with K2b) "
        f"{collect_ms:.3f} ms, bootstrap and GAE {gae_ms:.3f} ms, {n_passes} band passes (K9 + "
        f"loss + K10 + optimizer) {passes_ms:.3f} ms [{kind}, {card}]")
    # K2c with K2b at the main path's shapes, from the runner's state and
    # carry, beside its plain version.
    rpolicy = ippo_rnn.rnn_policy_of(gdims, runner.params)
    args = (runner.env_states, rpolicy, 7, runner.carry)
    k2cm_ms, _ = cuda_ms(lambda: step.collect(*args), repeats=2)
    k2cm_plain_ms, _ = cuda_ms(lambda: step.collect.plain(*args))
    _, _, _, k2cm_err = compare_k2b("rware-tiny-2ag-v2", dev, n_envs, rollout_len, False, 6,
                                    "gru", rpolicy, step.collect, runner.env_states,
                                    runner.carry, msg_bits=2)
    log(f"phase 20 K2c with K2b at the main shape B={n_envs} T={rollout_len} random, from the "
        f"runner's state and carry: obs/reward/done/bits/actions/state/carry exact, "
        f"{k2cm_ms:.3f} ms/launch (plain {k2cm_plain_ms:.1f} ms, value/logp max_abs_err "
        f"{k2cm_err}) [{kind}, {card}]")
    for deterministic in (True, False):
        _, _, collect, err = compare_k2b(NARROW_CASE[0], dev, 1000, BREADTH_T, deterministic, 5,
                                         "gru", hidden=NARROW_CASE[1], msg_bits=2,
                                         max_steps=BREADTH_MAX_STEPS)
        log(f"phase 20 K2c with K2b {NARROW_CASE[0]} (embed, hidden) {NARROW_CASE[1]} M=2 "
            f"B=1000 T={BREADTH_T} deterministic={deterministic}: obs/reward/done/bits/actions/"
            f"state/carry "
            f"exact, value/logp err {err} ({tile_note(collect, 1000)})")
    k2cm_bound = bound(2 * state_bytes(states) + tensor_bytes(*traj.values())
                       + 2 * tensor_bytes(runner.carry) + 4.0 * gdims.n_params,
                       steps * env.n_agents * gru_cell_flops(gdims, True),
                       steps * env.n_agents * 2.0 * gdims.hidden
                       * (gdims.n_actions + 1 + gdims.msg_bits))
    entries.append(kernel_entry("fused_collect_gru (message bits, K2b)", "collect_gru.cuh",
                                "rware_tpu/ops/pallas_rollout.py:1537", k2c_launches, k2cm_err,
                                k2cm_ms, k2cm_plain_ms, k2cm_bound))

    # MAPPO's split path: K2a with K2b, K6, per pass K4 (vf_coef 0) and the
    # critic by autograd, no K5 or K7.
    runner, adims, cdims = mappo.init_mappo_runner(env, cfg, seed=0)
    step = mappo.build_mappo_train_step(env, adims, cdims, cfg)
    require(isinstance(step.grads, mappo.MappoSplitGrads), "MAPPO took another path")
    runner, _ = _time_learner(
        "MAPPO split", step, runner,
        {"fused_collect": step.collect, "fused_critic_values": step.critic_values,
         "fused_ppo_grads": step.grads.actor},
        {"fused_collect": 3, "fused_critic_values": 3, "fused_ppo_grads": 3 * n_passes},
        kind, card, cfg)
    collect_ms, (states, traj) = cuda_ms(lambda: step.rollout(runner))
    k6_ms, values = cuda_ms(lambda: step.values(runner, traj))
    gae_ms, (obs, adv, targets) = cuda_ms(lambda: step.advantages(runner, states, traj, values))
    dataset = (traj["obs"], traj["action"], traj["logp"], values, adv, targets, traj["bits"])
    passes_ms, _ = cuda_ms(lambda: step.update(runner, dataset))
    log(f"phase 20 MAPPO split breakdown of one update: collect (K2a with K2b) {collect_ms:.3f} "
        f"ms, critic values (K6) {k6_ms:.3f} ms, GAE and bootstrap {gae_ms:.3f} ms, {n_passes} "
        f"passes (K4 + critic autograd + split optimizer) {passes_ms:.3f} ms [{kind}, {card}]")
    return entries


def compare_k2dp(env_id, dev, b, t, deterministic, seed, policies=None, collect=None,
                 states=None, h0=None, heads_global=None, hidden=(128, 128), **overrides):
    """K2d′ (with its message mode K2b where ``overrides`` give ``msg_bits``)
    against its plain version on the card, from a reset and a random nonzero
    carry unless ``states`` and ``h0`` are given; ``heads_global`` True reads
    the agents' bias and head blocks from device memory, False holds them in
    shared memory (None: the plan's choice).  Obs, rewards, done,
    bits, every action, the final state and the new carry exact; returns
    (env, traj, collector, value/logp error)."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models.networks import init_recurrent_actor_critic
    from rware_tpu_torch.ops.fused_rollout import build_fused_collect_gru_per_agent
    from rware_tpu_torch.parallel import batched_reset

    env = rware_tpu_torch.make(env_id, device=dev, **overrides)
    m, n, length = env.config.msg_bits, env.n_agents, env.config.policy_obs_length
    gen = torch.Generator().manual_seed(seed)
    if states is None:
        states, _ = batched_reset(env, seed, b)
    if h0 is None:
        h0 = (torch.rand((b, n, hidden[1]), generator=gen) * 2 - 1).to(torch.bfloat16).to(dev)
    if policies is None:  # each agent its own GRU, biases off zero
        policies = torch.nn.ModuleList(
            init_recurrent_actor_critic(length, 5, hidden[1], hidden[0], (seed, 2, i), m)
            for i in range(n))
        with torch.no_grad():
            for p in policies.parameters():
                if p.dim() == 1:
                    p.copy_(0.3 * torch.randn(p.shape, generator=gen))
        policies = policies.to(dev)
    collect = collect or build_fused_collect_gru_per_agent(env.config, t, hidden, deterministic)
    if heads_global is not None:
        collect.heads_global = heads_global
    ks, kh, ktraj = collect(states, policies, seed + 1, h0)
    ps, ph, ptraj = collect.plain(states, policies, seed + 1, h0)
    torch.cuda.synchronize()
    what = f"K2d′ {env_id} M={m} deterministic={deterministic}"
    require(torch.equal(kh, ph), f"{what}: the new carry differs")
    for k in ("obs", "reward", "done", "action") + (("bits",) if m else ()):
        require(torch.equal(ktraj[k], ptraj[k]), f"{what}: {k} differs")
    bad = state_diff(ks, ps)
    require(not bad, f"{what}: final state differs in {bad}")
    err = max(float((ktraj[k] - ptraj[k]).abs().max()) for k in ("value", "logp"))
    require(err <= VALUE_LOGP_ATOL, f"{what}: value/logp err {err}")
    for k, v in ktraj.items():
        require(not v.is_floating_point() or bool(torch.isfinite(v.float()).all()),
                f"{what}: non-finite {k}")
    last_done = ktraj["done"][-1]
    require(not bool(last_done.any()) or float(kh[last_done].float().abs().max()) == 0.0,
            f"{what}: the carry of an env whose episode just ended is not zero")
    a = ktraj["action"]
    require(n < 2 or bool((a[..., 0] != a[..., 1]).any()), f"{what}: the agents act alike")
    check_invariants(env, ks)
    return env, ktraj, collect, err


K2DP_CONFIGS = (("rware-tiny-2ag-v2", {}), ("rware-small-4ag-v2", {"max_steps": BREADTH_MAX_STEPS}),
                ("rware-large-8ag-v2", {"max_steps": BREADTH_MAX_STEPS}))


def phase21(dev, kind, card):
    """K2d′, K2d′ with K2b and K2d with K2b against their plain versions;
    returns the main shape's errors {name: max |value/logp error|}."""
    for env_id, overrides in K2DP_CONFIGS:
        for m in (0, 2):
            for deterministic in (True, False):
                _, traj, collect, err = compare_k2dp(env_id, dev, 1000, BREADTH_T, deterministic, 5,
                                                     msg_bits=m, **overrides)
                log(f"phase 21 K2d′ {env_id} M={m} B=1000 T={BREADTH_T} "
                    f"deterministic={deterministic}: "
                    f"obs/reward/done/bits/actions/state/carry exact, value/logp err {err} "
                    f"(bias and head blocks in {tile_note(collect, 1000)})")
    _, _, collect, err = compare_k2dp("rware-large-8ag-v2", dev, 1000, BREADTH_T, False, 6,
                                      heads_global=True, msg_bits=2, max_steps=BREADTH_MAX_STEPS)
    log(f"phase 21 K2d′ rware-large-8ag-v2 M=2 B=1000 T={BREADTH_T} random, bias and head "
        f"blocks read "
        f"from device memory: obs/reward/done/bits/actions/state/carry exact, value/logp err "
        f"{err} ({tile_note(collect, 1000)})")
    for heads_global in (False, True):
        for m in (0, 2):
            for deterministic in (True, False):
                _, _, collect, err = compare_k2dp(NARROW_CASE[0], dev, 1000, BREADTH_T,
                                                  deterministic,
                                                  5, heads_global=heads_global,
                                                  hidden=NARROW_CASE[1], msg_bits=m,
                                                  max_steps=BREADTH_MAX_STEPS)
                log(f"phase 21 K2d′ {NARROW_CASE[0]} (embed, hidden) {NARROW_CASE[1]} M={m} "
                    f"B=1000 T={BREADTH_T} deterministic={deterministic}: obs/reward/done/bits/"
                    f"actions/"
                    f"state/carry exact, value/logp err {err} (bias and head blocks in "
                    f"{tile_note(collect, 1000)})")
    errs = {}
    for m in (0, 2):
        _, _, collect, err = compare_k2dp("rware-tiny-2ag-v2", dev, 16384, 128, False, 13,
                                          msg_bits=m)
        errs[f"k2dp{m}"] = err
        log(f"phase 21 K2d′ main shape tiny-2ag M={m} B=16384 T=128 random: obs/reward/done/"
            f"bits/actions/state/carry exact, value/logp max_abs_err {err} [{kind}, {card}]")
    for env_id, overrides in (("rware-tiny-2ag-v2", {}), ("rware-large-8ag-v2",
                                                         {"max_steps": BREADTH_MAX_STEPS})):
        for deterministic in (True, False):
            _, _, _, err, collect = compare_k2d(env_id, dev, 1000, BREADTH_T, deterministic, 5,
                                                msg_bits=2, **overrides)
            log(f"phase 21 K2d with K2b {env_id} M=2 B=1000 T={BREADTH_T} "
                f"deterministic={deterministic}: "
                f"obs/reward/done/bits/actions/state exact, value/logp err {err} (weights "
                f"{'in device memory' if collect.weights_global else 'in shared memory'})")
    return errs


def gru_collect_bound(dims, states, traj, carry, n_params, agent_steps):
    """``bound`` of a recurrent collector launch: the state and the carry in
    and out, the trajectory written, the parameters read once, and the
    cell's and heads' products of every agent-step (integer work charged
    nothing, as for K2a)."""
    return bound(2 * state_bytes(states) + tensor_bytes(*traj.values())
                 + 2 * tensor_bytes(carry) + 4.0 * n_params,
                 agent_steps * gru_cell_flops(dims, True),
                 agent_steps * 2.0 * dims.hidden * (dims.n_actions + 1 + dims.msg_bits))


def phase22(dev, kind, card, errs, n_envs=4096, rollout_len=128):
    """Recurrent SEAC-PPO at full width, without and with message bits;
    returns the K2d′ entries."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models import seac

    entries = []
    for m in (0, 2):
        env = rware_tpu_torch.make("rware-tiny-2ag-v2", msg_bits=m)  # no device named: the card
        require(env.device.type == "cuda", f"make's default device is {env.device}")
        cfg = seac.SEACPPOConfig(n_envs=n_envs, rollout_len=rollout_len, epochs=4, minibatches=4)
        n_passes, steps = cfg.epochs * cfg.minibatches, cfg.n_envs * cfg.rollout_len
        runner, dims = seac.init_seac_gru(env, cfg, seed=0)
        step = seac.build_seac_gru_train_step(env, dims, cfg)
        params0 = runner.params.clone()
        runner, update_ms = _time_learner(
            "recurrent SEAC-PPO", step, runner,
            {"fused_collect_gru_per_agent": step.collect}, {"fused_collect_gru_per_agent": 3},
            kind, card, cfg, phase=22)
        launches = step.collect.launches
        moved = [float((a - b).abs().max()) for i in range(env.n_agents)
                 for a, b in zip(dims.split(runner.params[i]), dims.split(params0[i]))]
        require(min(moved) > 0, f"recurrent SEAC-PPO left a block unmoved: {moved}")
        require(not step.remat, "recurrent SEAC-PPO at tiny-2ag B=4096 took remat")
        collect_ms, (states, new_carry, traj) = cuda_ms(lambda: step.rollout(runner))
        adv_ms, (obs, values, adv, targets) = cuda_ms(
            lambda: step.advantages(runner, states, traj))
        dataset = (traj["obs"], traj["done"], traj["action"], traj["logp"], values, adv,
                   targets, runner.carry) + ((traj["bits"],) if m else ())
        passes_ms, _ = cuda_ms(lambda: step.update(runner, dataset))
        log(f"phase 22 recurrent SEAC-PPO M={m} breakdown of one update: collect (K2d′) "
            f"{collect_ms:.3f} ms, cross replay, bootstrap and cross GAE {adv_ms:.3f} ms, "
            f"{n_passes} band passes (cross replay + loss by autograd + optimizer) "
            f"{passes_ms:.3f} ms [{kind}, {card}]")
        # K2d′ at the main path's shape, from the runner's state and carry
        policies = seac.seac_gru_policies_of(dims, runner.params)
        args = (runner.env_states, policies, 7, runner.carry)
        k_ms, plain_ms, err, _ = route_check(f"K2d′ M={m} main path's shape", env,
                                             step.collect, args)
        log(f"phase 22 K2d′ M={m} at the main path's shape B={n_envs} T={rollout_len} random, "
            f"from the runner's state and carry: obs/reward/done/bits/actions/state/carry exact, "
            f"{k_ms:.3f} ms/launch (plain {plain_ms:.1f} ms, value/logp max_abs_err {err}; at "
            f"B=16384: {errs[f'k2dp{m}']}) [{kind}, {card}]")
        k_bound = gru_collect_bound(dims, states, traj, runner.carry, runner.params.numel(),
                                    float(steps * env.n_agents))
        name = "fused_collect_gru_per_agent" + (" (message bits, K2b)" if m else "")
        replaces = "rware_tpu/ops/pallas_rollout.py:" + ("1537" if m else "1376")
        entries.append(kernel_entry(name, "collect_gru.cuh", replaces, launches,
                                    max(err, errs[f"k2dp{m}"]), k_ms, plain_ms, k_bound))
    return entries


def phase23(dev, kind, card, n_envs=16384, rollout_len=128):
    """SEAC-PPO with two message bits at full width; returns the K2d with
    K2b entry."""
    import rware_tpu_torch
    from rware_tpu_torch.models import seac

    env = rware_tpu_torch.make("rware-tiny-2ag-v2", msg_bits=2)  # no device named: the card
    require(env.device.type == "cuda", f"make's default device is {env.device}")
    cfg = seac.SEACPPOConfig(n_envs=n_envs, rollout_len=rollout_len, epochs=4, minibatches=4)
    n_passes, steps = cfg.epochs * cfg.minibatches, cfg.n_envs * cfg.rollout_len
    runner, dims = seac.init_seac_ppo(env, cfg, seed=0)
    step = seac.build_seac_ppo_train_step(env, dims, cfg)
    require(not hasattr(step, "grads"), "SEAC-PPO with message bits built K8")
    runner, _ = _time_learner(
        "SEAC-PPO", step, runner, {"fused_collect_per_agent": step.collect},
        {"fused_collect_per_agent": 3}, kind, card, cfg, phase=23)
    launches = step.collect.launches
    collect_ms, (states, traj) = cuda_ms(lambda: step.rollout(runner))
    adv_ms, (obs, values, adv, targets) = cuda_ms(lambda: step.advantages(runner, states, traj))
    dataset = (traj["obs"], traj["action"], traj["logp"], values, adv, targets, traj["bits"])
    passes_ms, _ = cuda_ms(lambda: step.update(runner, dataset))
    log(f"phase 23 SEAC-PPO M=2 breakdown of one update: collect (K2d with K2b) "
        f"{collect_ms:.3f} ms, cross values, bootstrap and cross GAE {adv_ms:.3f} ms, "
        f"{n_passes} flat minibatches (cross forward + loss by autograd + optimizer) "
        f"{passes_ms:.3f} ms; K8 launches 0 (not built) [{kind}, {card}]")
    policies = seac.seac_policies_of(dims, runner.params)
    args = (runner.env_states, policies, 7)
    k_ms, plain_ms, err, _ = route_check("K2d with K2b main shape", env, step.collect, args)
    log(f"phase 23 K2d with K2b at the main shape: {k_ms:.3f} ms/launch (plain {plain_ms:.1f} "
        f"ms; against it obs/reward/done/bits/actions/state exact, value/logp max_abs_err "
        f"{err}) [{kind}, {card}]")
    k_bound = collect_per_agent_bound(dims, states, traj, runner.params, steps * env.n_agents)
    return [kernel_entry("fused_collect_per_agent (message bits, K2b)", "collect_mlp.cuh",
                         "rware_tpu/ops/pallas_rollout.py:1537", launches, err, k_ms,
                         plain_ms, k_bound)]


# K2e: image ids and configs of phase 24 (every layer, AGENT_DIRECTION and
# AGENT_LOAD included, on a config of its own), each with the collectors it
# drives; small-4ag keeps K2d's weights in shared memory, large-8ag reads them
# from device memory.
IMAGE_ALL_LAYERS = (6, 3, 0, 4, 1, 5, 2)
K2E_CASES = (
    ("mlp", "rware-img-tiny-2ag-v2", 0), ("mlp", "rware-imgdict-tiny-2ag-v2", 0),
    ("mlp", "rware-img-Nd-tiny-2ag-v2", 0), ("mlp", "all-seven-layers", 0),
    ("mlp", "rware-img-tiny-2ag-v2", 2),
    ("gru", "rware-img-tiny-2ag-v2", 0), ("gru", "rware-imgdict-tiny-2ag-v2", 0),
    ("gru", "rware-img-Nd-tiny-2ag-v2", 0), ("gru", "all-seven-layers", 2),
    ("mlp_per_agent", "rware-img-tiny-2ag-v2", 0), ("mlp_per_agent", "rware-img-small-4ag-v2", 0),
    ("mlp_per_agent", "rware-img-large-8ag-v2", 0),
    ("gru_per_agent", "rware-img-tiny-2ag-v2", 0), ("gru_per_agent", "rware-img-small-4ag-v2", 0),
    ("gru_per_agent", "rware-img-large-8ag-v2", 0),
)
K2E_NAMES = {"mlp": "K2a", "gru": "K2c", "mlp_per_agent": "K2d", "gru_per_agent": "K2d′"}


def image_env(name, dev, **overrides):
    """The env of an image id, or of ``all-seven-layers``: imgdict-tiny-2ag
    with every image layer in an order other than the enum's."""
    import rware_tpu_torch
    from rware_tpu_torch.types import ImageLayer

    if name == "all-seven-layers":
        overrides["image_observation_layers"] = tuple(ImageLayer(k) for k in IMAGE_ALL_LAYERS)
        name = "rware-imgdict-tiny-2ag-v2"
    return rware_tpu_torch.make(name, device=dev, **overrides)


def image_policy(kind, config, seed, dev, hidden=(128, 128)):
    """A network of ``kind`` (one per agent for the per-agent kinds) at the
    config's policy observation length and message bits, MLP widths or (embed,
    GRU) widths ``hidden``, biases off zero."""
    import torch
    from rware_tpu_torch.models.networks import init_actor_critic, init_recurrent_actor_critic

    length, m = config.policy_obs_length, config.msg_bits
    per_agent = kind.endswith("per_agent")
    init = (lambda i: init_recurrent_actor_critic(length, 5, hidden[1], hidden[0], (seed, i),
                                                  m)) \
        if kind.startswith("gru") else (lambda i: init_actor_critic(length, 5, hidden,
                                                                    (seed, i), m))
    nets = torch.nn.ModuleList(init(i) for i in range(config.n_agents if per_agent else 1))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in nets.parameters():
            if p.dim() == 1:
                p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    nets = nets.to(dev)
    return nets if per_agent else nets[0]


def compare_k2e(kind, env, b, t, deterministic, seed, states=None, policy=None, h0=None,
                collect=None, hidden=(128, 128)):
    """The image mode (K2e) of the collector ``kind`` against its plain
    version on the card, from a reset (and a random nonzero carry) unless
    given: obs, rewards, done, bits, every action, the final state and the
    carry exact, value and logp within 2e-2; returns (collector, traj,
    value/logp error)."""
    import torch
    from rware_tpu_torch.ops import fused_rollout as fr
    from rware_tpu_torch.parallel import batched_reset

    dev, cfg, m = env.device, env.config, env.config.msg_bits
    if states is None:
        states, _ = batched_reset(env, seed, b)
    policy = policy if policy is not None else image_policy(kind, cfg, seed, dev, hidden)
    build = {"mlp": fr.build_fused_collect, "gru": fr.build_fused_collect_gru,
             "mlp_per_agent": fr.build_fused_collect_per_agent,
             "gru_per_agent": fr.build_fused_collect_gru_per_agent}[kind]
    collect = collect or build(cfg, t, hidden, deterministic=deterministic)
    args = (states, policy, seed + 1)
    if kind.startswith("gru"):
        if h0 is None:
            gen = torch.Generator().manual_seed(seed)
            h0 = torch.rand((b, env.n_agents, hidden[1]), generator=gen) * 2 - 1
            h0 = h0.to(torch.bfloat16)
        args += (h0.to(dev),)
    *kout, ktraj = collect(*args)
    *pout, ptraj = collect.plain(*args)
    torch.cuda.synchronize()
    what = f"{K2E_NAMES[kind]} with K2e {cfg.observation_type.name} M={m} " \
        f"deterministic={deterministic}"
    require(tuple(ktraj["obs"].shape[-1:]) == (cfg.policy_obs_length,), f"{what}: obs width")
    for k in ("obs", "reward", "done", "action") + (("bits",) if m else ()):
        require(torch.equal(ktraj[k], ptraj[k]), f"{what}: {k} differs")
    bad = state_diff(kout[0], pout[0])
    require(not bad, f"{what}: final state differs in {bad}")
    if kind.startswith("gru"):
        require(torch.equal(kout[1], pout[1]), f"{what}: the new carry differs")
    err = max(float((ktraj[k] - ptraj[k]).abs().max()) for k in ("value", "logp"))
    require(err <= VALUE_LOGP_ATOL, f"{what}: value/logp err {err}")
    for k, v in ktraj.items():
        require(not v.is_floating_point() or bool(torch.isfinite(v.float()).all()),
                f"{what}: non-finite {k}")
    require(float(ktraj["obs"].float().sum()) > 0, f"{what}: the windows are empty")
    check_invariants(env, kout[0])
    return collect, ktraj, err


def phase24(dev, kind, card):
    """K2e in the four collectors against their plain versions."""
    for coll, name, m in K2E_CASES:
        env = image_env(name, dev, max_steps=BREADTH_MAX_STEPS, msg_bits=m)
        for deterministic in (True, False):
            collect, traj, err = compare_k2e(coll, env, 1000, BREADTH_T, deterministic, 5)
            where = ""
            if coll == "mlp_per_agent":
                where = ", weights in " + ("device" if collect.weights_global else "shared") \
                    + " memory"
            log(f"phase 24 {K2E_NAMES[coll]} with K2e {name} M={m} B=1000 T={BREADTH_T} "
                f"deterministic={deterministic}: obs ({traj['obs'].shape[-1]} features)/reward/"
                f"done/bits/actions/state/carry exact, value/logp err {err} "
                f"({tile_note(collect, 1000)}{where})")
    for coll, m in (("gru", 0), ("gru", 2), ("gru_per_agent", 0), ("gru_per_agent", 2)):
        env = image_env("rware-img-tiny-2ag-v2", dev, max_steps=BREADTH_MAX_STEPS, msg_bits=m)
        for deterministic in (True, False):
            collect, traj, err = compare_k2e(coll, env, 1000, BREADTH_T, deterministic, 5,
                                             hidden=NARROW_CASE[1])
            log(f"phase 24 {K2E_NAMES[coll]} with K2e rware-img-tiny-2ag-v2 (embed, hidden) "
                f"{NARROW_CASE[1]} M={m} B=1000 T={BREADTH_T} deterministic={deterministic}: "
                f"obs/reward/"
                f"done/bits/actions/state/carry exact, value/logp err {err} "
                f"({tile_note(collect, 1000)})")
    from rware_tpu_torch.ops.fused_rollout import build_fused_collect_per_agent, collect_plan

    env = image_env("rware-img-tiny-2ag-v2", dev, max_steps=BREADTH_MAX_STEPS)
    for weights_global in (False, True):
        for deterministic in (True, False):
            collect = build_fused_collect_per_agent(env.config, BREADTH_T, NARROW_CASE[1],
                                                    deterministic=deterministic)
            collect.plan = collect_plan(env.config, NARROW_CASE[1], env.n_agents,
                                        weights_global=weights_global)
            policy = image_policy("mlp_per_agent", env.config, 5, dev, NARROW_CASE[1])
            _, traj, err = compare_k2e("mlp_per_agent", env, 1000, BREADTH_T, deterministic, 5,
                                       policy=policy, collect=collect)
            log(f"phase 24 K2d with K2e rware-img-tiny-2ag-v2 hidden {NARROW_CASE[1]} B=1000 "
                f"T={BREADTH_T} deterministic={deterministic}: obs/reward/done/actions/state "
                f"exact, "
                f"value/logp err {err} (weights in {'device' if weights_global else 'shared'} "
                f"memory, {collect.threads} threads)")


def phase25(dev, kind, card, n_envs=16384, rollout_len=128):
    """Image IPPO and image recurrent IPPO at full width; returns the two
    image collectors' entries."""
    import rware_tpu_torch
    from rware_tpu_torch.models import ippo, ippo_rnn
    from rware_tpu_torch.models.ippo_fused import build_fused_train_step

    env = rware_tpu_torch.make("rware-img-tiny-2ag-v2")  # no device named: the card
    require(env.device.type == "cuda", f"make's default device is {env.device}")
    cfg = ippo.IPPOConfig(n_envs=n_envs, rollout_len=rollout_len, epochs=4, minibatches=4)
    n_passes, steps = cfg.epochs * cfg.minibatches, cfg.n_envs * cfg.rollout_len
    agent_steps = float(steps * env.n_agents)
    entries = []

    runner, dims = ippo.init_runner(env, cfg, seed=0)
    require(dims.obs_len == env.config.policy_obs_length == 45, f"obs_len {dims.obs_len}")
    step = build_fused_train_step(env, dims, cfg)
    runner, _ = _time_learner(
        "image IPPO", step, runner, {"fused_collect": step.collect,
                                     "fused_ppo_update_phase": step.update_phase,
                                     "fused_ppo_grads": step.grads},
        {"fused_collect": 3, "fused_ppo_update_phase": 3, "fused_ppo_grads": 0}, kind, card,
        cfg, phase=25)
    launches = step.collect.launches
    collect_ms, (states, traj) = cuda_ms(lambda: step.rollout(runner))
    gae_ms, (obs, adv, targets) = cuda_ms(lambda: step.advantages(runner, states, traj))
    dataset = (traj["obs"], traj["action"], traj["logp"], traj["value"], adv, targets)
    phase_ms, _ = cuda_ms(lambda: step.update(runner, dataset))
    log(f"phase 25 image IPPO breakdown of one update: collect (K2a with K2e) {collect_ms:.3f} "
        f"ms, GAE and last value {gae_ms:.3f} ms, update phase (K3, {n_passes} passes) "
        f"{phase_ms:.3f} ms [{kind}, {card}]")
    policy = ippo.policy_of(dims, runner.params)
    args = (runner.env_states, policy, 7)
    k_ms, _ = cuda_ms(lambda: step.collect(*args), repeats=2)
    plain_ms, _ = cuda_ms(lambda: step.collect.plain(*args))
    _, _, err = compare_k2e("mlp", env, n_envs, rollout_len, False, 7, states=runner.env_states,
                            policy=policy, collect=step.collect)
    log(f"phase 25 K2a with K2e at the main shape: {k_ms:.3f} ms/launch (plain {plain_ms:.1f} "
        f"ms); kernel against plain from the runner's state: obs/reward/done/actions/state "
        f"exact, value/logp max_abs_err {err} [{kind}, {card}]")
    bf, f32 = mlp_flops(dims.obs_len, dims.h1, dims.h2, dims.heads, agent_steps, False)
    entries.append(kernel_entry(
        "fused_collect (image observations, K2e)", "collect_mlp.cuh",
        "rware_tpu/ops/pallas_rollout.py:1109", launches, err, k_ms, plain_ms,
        bound(2 * state_bytes(states) + tensor_bytes(*traj.values())
              + 4.0 * runner.params.numel(), bf, f32)))

    runner, dims = ippo_rnn.init_rnn_runner(env, cfg, seed=0)
    step = ippo_rnn.build_rnn_fused_train_step(env, dims, cfg)
    runner, _ = _time_learner(
        "image recurrent IPPO", step, runner,
        {"fused_collect_gru": step.collect, "fused_gru_obs_fwd": step.gru_fwd,
         "fused_gru_obs_bwd": step.gru_bwd},
        {"fused_collect_gru": 3, "fused_gru_obs_fwd": 3 * n_passes,
         "fused_gru_obs_bwd": 3 * n_passes}, kind, card, cfg, phase=25)
    launches = step.collect.launches
    collect_ms, (states, new_carry, traj) = cuda_ms(lambda: step.rollout(runner))
    gae_ms, (obs, adv, targets) = cuda_ms(
        lambda: step.advantages(runner, states, new_carry, traj))
    dataset = (traj["obs"], traj["done"], traj["action"], traj["logp"], traj["value"], adv,
               targets, runner.carry)
    passes_ms, _ = cuda_ms(lambda: step.update(runner, dataset))
    log(f"phase 25 image recurrent IPPO breakdown of one update: collect (K2c with K2e) "
        f"{collect_ms:.3f} ms, bootstrap and GAE {gae_ms:.3f} ms, {n_passes} band passes (K9 + "
        f"loss + K10 + optimizer) {passes_ms:.3f} ms [{kind}, {card}]")
    policy = ippo_rnn.rnn_policy_of(dims, runner.params)
    args = (runner.env_states, policy, 7, runner.carry)
    k_ms, _ = cuda_ms(lambda: step.collect(*args), repeats=2)
    plain_ms, _ = cuda_ms(lambda: step.collect.plain(*args))
    _, _, err = compare_k2e("gru", env, n_envs, rollout_len, False, 7, states=runner.env_states,
                            policy=policy, h0=runner.carry, collect=step.collect)
    log(f"phase 25 K2c with K2e at the main shape: {k_ms:.3f} ms/launch (plain {plain_ms:.1f} "
        f"ms); kernel against plain from the runner's state and carry: obs/reward/done/actions/"
        f"state/carry exact, value/logp max_abs_err {err} [{kind}, {card}]")
    entries.append(kernel_entry(
        "fused_collect_gru (image observations, K2e)", "fused_collect_gru_image_one_stack.cu",
        "rware_tpu/ops/pallas_rollout.py:1109", launches, err, k_ms, plain_ms,
        gru_collect_bound(dims, states, traj, runner.carry, dims.n_params, agent_steps)))
    return entries


# K11-K13: configs of phase 26 (the kernels read the gates, so the sensor range
# matters only through the embed that makes them; 16 agents cut the bands
# across agents; hidden 40 is a multiple of 8 but not of 16, so K12's and
# K13's tensor-core tiles run padded and masked).  (env id, B, T, bands,
# (embed, hidden))
SEQ_CASES = (
    ("rware-tiny-2ag-v2", 1000, 8, ((0, 1000), (900, 500)), (128, 128)),
    ("rware-3s-tiny-2ag-v2", 1000, 8, ((600, 700),), (128, 128)),
    ("rware-tiny-16ag-v2", 1000, 4, ((950, 100),), (128, 128)),
    ("rware-tiny-2ag-v2", 1000, 8, ((900, 500),), (24, 40)),
    ("rware-tiny-16ag-v2", 1000, 4, ((950, 100),), (24, 40)),
)
SEQ_METRIC_RTOL = 1e-3


def k11_plan(dims, n_agents, n_env):
    """K11's launch shape on a band, for the log: its tile S, grid and shared
    memory (``gru_seq_fwd_plan``)."""
    from rware_tpu_torch.ops.fused_gru import gru_seq_fwd_plan

    plan = gru_seq_fwd_plan(dims, n_agents, n_env)
    return f"K11 S={plan.rows}, {plan.blocks} blocks, {plan.smem} B shared memory"


def compare_gru_seq(dims, a, band, seed, fwd=None, bwd=None, loss=None, what="K11-K13"):
    """K11, K12 and K13 kernels vs their plain versions on one band of the
    inputs ``a`` (``random_gru_seq_case``'s keys; K12 and K13 from the plain
    hseq, so that each comparison is of one kernel alone); two launches of
    each bit-equal.  Returns (fwd, bwd, loss, max |hseq diff|, max |K12
    diff|, max |K13 diff|) with the differences in float32."""
    import torch
    from rware_tpu_torch.ops.fused_gru import (
        build_fused_gru_loss_bwd,
        build_fused_gru_seq_bwd,
        build_fused_gru_seq_fwd,
    )

    fwd = fwd or build_fused_gru_seq_fwd(dims)
    bwd = bwd or build_fused_gru_seq_bwd(dims)
    loss = loss or build_fused_gru_loss_bwd(dims, 0.2, 0.5, 0.01)
    tag = f"{what} band {band}"
    seq = (a["wh"], a["bhn"], a["iall"], a["done"], a["h0"])
    kh, kh2, ph = fwd(*seq, *band), fwd(*seq, *band), fwd.plain(*seq, *band)
    torch.cuda.synchronize()
    require(torch.equal(kh, kh2), f"{tag}: two K11 launches differ")
    require(bool(torch.isfinite(kh.float()).all()), f"{tag}: non-finite hseq")
    diff = (kh.float() - ph.float()).abs()
    share = float((diff <= BF16_STEP).float().mean())
    require(share >= ACTION_AGREEMENT and float(diff.max()) <= 8 * BF16_STEP,
            f"{tag}: hseq within a bf16 step on {share}, max {float(diff.max())}")

    def close(got, want, name):
        err = float((got.float() - want.float()).abs().max())
        top = max(float(want.float().abs().max()), 1e-12)
        require(bool(torch.isfinite(got.float()).all()) and err <= GRAD_FRAC * top,
                f"{tag}: {name} differs by {err} > {GRAD_FRAC} * {top}")
        return err

    gen = torch.Generator().manual_seed(seed)
    dh = (torch.randn(ph.shape, generator=gen) * 1e-2).to(torch.bfloat16).to(ph.device)
    k12, k12b, p12 = (f(*seq, ph, dh, *band) for f in (bwd, bwd, bwd.plain))
    torch.cuda.synchronize()
    require(all(torch.equal(x, y) for x, y in zip(k12, k12b)), f"{tag}: two K12 launches differ")
    e12 = max(close(g, w, n) for g, w, n in zip(k12, p12, ("dWh", "dbhn", "d_iall", "dh0")))
    largs = (a["wh"], a["bhn"], a["whead"], a["bhead"], a["iall"], a["done"], a["h0"], ph,
             a["action"], a["logp"], a["value"], a["adv"], a["target"], a["stats"], *band)
    k13, k13b, p13 = loss(*largs), loss(*largs), loss.plain(*largs)
    torch.cuda.synchronize()
    require(all(torch.equal(x, y) for x, y in zip(k13, k13b)), f"{tag}: two K13 launches differ")
    names = ("d_iall", "dWh", "dbhn", "dW_head", "db_head", "dh0")
    e13 = max(close(g, w, n) for g, w, n in zip(k13[:6], p13[:6], names))
    # as K4's check: pg's sum is one of normalised advantages, near 0
    n = float(ph[..., 0].numel())
    got, want = k13[6].double() / n, p13[6].double() / n
    require(bool(((got - want).abs() <= SEQ_METRIC_RTOL * want.abs() + 1e-5).all()),
            f"{tag}: K13 metric means {got.tolist()} vs {want.tolist()}")
    return fwd, bwd, loss, float(diff.max()), e12, e13


def compare_gru_seq_scan(dims, a, band, seed):
    """``GruSeqScan`` on the kernels (K11 forward, K12 backward) against the
    same autograd call on their plain versions, on the card: hseq as
    :func:`compare_gru_seq` holds it, the gradients of wh, bhn, iall and h0
    (zero outside the band) within ``GRAD_FRAC`` of each one's largest
    |plain|.  Returns the largest gradient difference."""
    import torch
    from rware_tpu_torch.ops.fused_gru import (
        GruSeqScan,
        build_fused_gru_seq_bwd,
        build_fused_gru_seq_fwd,
    )

    fwd, bwd = build_fused_gru_seq_fwd(dims), build_fused_gru_seq_bwd(dims)
    gen = torch.Generator().manual_seed(seed)
    t_len, n_env, n = a["iall"].shape[:3]
    w = torch.randn((t_len, n_env, n, dims.hidden), generator=gen).to(a["iall"].device)
    runs = []
    for f, b in ((fwd, bwd), (fwd.plain, bwd.plain)):
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (a["wh"], a["bhn"], a["iall"], a["h0"])]
        wh, bhn, iall, h0 = leaves
        hseq = GruSeqScan.apply(wh, bhn, iall, a["done"], h0, *band, f, b)
        (hseq.float() * w).sum().backward()
        runs.append((hseq.detach(), [x.grad for x in leaves]))
    torch.cuda.synchronize()
    require(fwd.launches == 1 and bwd.launches == 1,
            f"GruSeqScan launched K11 {fwd.launches} and K12 {bwd.launches} times, not once each")
    (kh, kg), (ph, pg) = runs
    diff = (kh.float() - ph.float()).abs()
    share = float((diff <= BF16_STEP).float().mean())
    require(share >= ACTION_AGREEMENT and float(diff.max()) <= 8 * BF16_STEP,
            f"GruSeqScan band {band}: hseq within a bf16 step on {share}, max {float(diff.max())}")
    err = 0.0
    for name, g, want in zip(("wh", "bhn", "iall", "h0"), kg, pg):
        e = float((g.float() - want.float()).abs().max())
        top = max(float(want.float().abs().max()), 1e-12)
        require(bool(torch.isfinite(g.float()).all()) and e <= GRAD_FRAC * top,
                f"GruSeqScan band {band}: d{name} differs by {e} > {GRAD_FRAC} * {top}")
        err = max(err, e)
    return err


def seq_bounds(dims, a, band, hseq):
    """``bound`` of K11, K12 and K13 on one band: each reads its band of the
    inputs once and writes its outputs once; the products are K11's hidden
    gates (Hg x 3Hg per sequence-step), K12's recomputed gates, dh and dWh
    (three times that), K13's as K12's plus the heads, dW_head and the
    heads' cotangent (3 x Hg x (A + 1))."""
    hg, a1 = dims.hidden, dims.n_actions + 1
    share = band[1] / a["done"].shape[1]
    steps = float(hseq[..., 0].numel())
    w_in = 2.0 * hg * 3 * hg + 4.0 * hg
    band_in = share * tensor_bytes(a["done"], a["h0"])
    seq = tensor_bytes(hseq)
    mac = 2.0 * steps * hg * 3 * hg
    grads_out = 4.0 * (hg * 3 * hg + hg) + 4.0 * hseq[0].numel()
    streams = share * tensor_bytes(*(a[k] for k in ("action", "logp", "value", "adv", "target")))
    return (
        bound(tensor_bytes(a["iall"]) + band_in + w_in + seq, mac),
        bound(tensor_bytes(a["iall"]) + band_in + w_in + 2 * seq + tensor_bytes(a["iall"])
              + grads_out, 3 * mac),
        bound(2 * tensor_bytes(a["iall"]) + band_in + w_in + seq + streams
              + 4.0 * (hg + 1) * a1 * 2 + grads_out + 16.0,
              3 * mac + 3 * 2.0 * steps * hg * a1),
    )


def phase26(dev, kind, card, n_envs=16384, rollout_len=128):
    """K11, K12 and K13 against their plain versions."""
    from rware_tpu_torch.testing import random_gru_seq_case

    for env_id, b, t_len, bands, (embed, hidden) in SEQ_CASES:
        for band in bands:
            dims, a = random_gru_seq_case(env_id, b, t_len, band, 29, dev, hidden=hidden,
                                          embed=embed)
            _, _, _, h_err, e12, e13 = compare_gru_seq(dims, a, band, 31,
                                                       what=f"{env_id} hidden {hidden}")
            log(f"phase 26 K11, K12, K13 {env_id} (N={a['h0'].shape[1]}, Hg={hidden}) B={b} "
                f"T={t_len} band {band} ({k11_plan(dims, a['h0'].shape[1], band[1])}): "
                f"hseq max_abs_err {h_err}, K12 and K13 within "
                f"{GRAD_FRAC} of each block (max_abs_err {e12}, {e13}), metric sums within rtol "
                f"{SEQ_METRIC_RTOL}, two launches bit-equal [{kind}, {card}]")
    env_id, b, t_len, bands, _ = SEQ_CASES[0]
    band = bands[-1]
    dims, a = random_gru_seq_case(env_id, b, t_len, band, 29, dev)
    scan_err = compare_gru_seq_scan(dims, a, band, 33)
    log(f"phase 26 GruSeqScan (K11 + K12 under autograd) {env_id} B={b} T={t_len} band {band} "
        f"({k11_plan(dims, a['h0'].shape[1], band[1])}): "
        f"gradients of wh, bhn, iall, h0 within {GRAD_FRAC} of each one's largest |plain| "
        f"(max_abs_err {scan_err}) [{kind}, {card}]")
    # the first band of an epoch at row offset 5 (epoch_band_starts): it wraps
    band = ((n_envs - 5 * 128) % n_envs, n_envs // 4)
    dims, a = random_gru_seq_case("rware-tiny-2ag-v2", n_envs, rollout_len, band, 37, dev)
    _, _, _, h_err, e12, e13 = compare_gru_seq(dims, a, band, 41, what="main band")
    log(f"phase 26 K11, K12, K13 main band tiny-2ag B={n_envs} T={rollout_len} band {band} "
        f"({k11_plan(dims, a['h0'].shape[1], band[1])}): hseq "
        f"max_abs_err {h_err}, K12 and K13 within {GRAD_FRAC} of each block (max_abs_err "
        f"{e12}, {e13}), two launches bit-equal [{kind}, {card}]")


class AllSeqBwdLaunches:
    """The launches of every K12 wrapper (``FusedGruSeqBwd.all_launches``) as
    one counter that :func:`_time_learner` can reset and read: the learner
    builds none, so a launch from anywhere on its path would count."""

    @property
    def launches(self):
        from rware_tpu_torch.ops.fused_gru import FusedGruSeqBwd

        return FusedGruSeqBwd.all_launches

    @launches.setter
    def launches(self, value):
        from rware_tpu_torch.ops.fused_gru import FusedGruSeqBwd

        FusedGruSeqBwd.all_launches = value


def phase27(dev, kind, card, n_envs=16384, rollout_len=128):
    """The loss-fused recurrent IPPO update at full width; returns the K11,
    K12 and K13 entries."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models import ippo, ippo_rnn
    from rware_tpu_torch.models.networks import gru_embed_gates
    from rware_tpu_torch.ops.fused_gru import build_fused_gru_seq_bwd

    env = rware_tpu_torch.make("rware-tiny-2ag-v2")  # no device named: the card
    require(env.device.type == "cuda", f"make's default device is {env.device}")
    cfg = ippo.IPPOConfig(n_envs=n_envs, rollout_len=rollout_len, epochs=4, minibatches=4)
    n_passes = cfg.epochs * cfg.minibatches
    runner, dims = ippo_rnn.init_rnn_runner(env, cfg, seed=0)
    step = ippo_rnn.build_rnn_fused_train_step(env, dims, cfg, fused_loss=True)
    counted = {"fused_collect_gru": step.collect, "fused_gru_seq_fwd": step.seq_fwd,
               "fused_gru_loss_bwd": step.loss_bwd, "fused_gru_obs_fwd": step.gru_fwd,
               "fused_gru_obs_bwd": step.gru_bwd, "fused_gru_seq_bwd": AllSeqBwdLaunches()}
    want = {"fused_collect_gru": 3, "fused_gru_seq_fwd": 3 * n_passes,
            "fused_gru_loss_bwd": 3 * n_passes, "fused_gru_obs_fwd": 0, "fused_gru_obs_bwd": 0,
            "fused_gru_seq_bwd": 0}
    params0 = runner.params.clone()
    runner, _ = _time_learner("fused-loss recurrent IPPO", step, runner, counted, want, kind,
                              card, cfg, phase=27)
    launches = {k: w.launches for k, w in counted.items()}
    moved = [float((x - y).abs().max())
             for x, y in zip(dims.split(runner.params), dims.split(params0))]
    require(min(moved) > 0, f"the fused-loss update left a block unmoved: {moved}")

    collect_ms, (states, new_carry, traj) = cuda_ms(lambda: step.rollout(runner))
    gae_ms, (obs, adv, targets) = cuda_ms(
        lambda: step.advantages(runner, states, new_carry, traj))
    dataset = (traj["obs"], traj["done"], traj["action"], traj["logp"], traj["value"], adv,
               targets, runner.carry)
    passes_ms, _ = cuda_ms(lambda: step.update(runner, dataset))
    n_env, starts = ippo_rnn.epoch_band_starts(cfg, 5)
    band = (starts[0], n_env)  # rows 27..31 and 0..2: a band that wraps
    grads_ms, _ = cuda_ms(lambda: ippo_rnn.rnn_fused_grads(cfg, dims, runner.params, dataset,
                                                           band, step.seq_fwd, step.loss_bwd))
    log(f"phase 27 breakdown of one update: collect (K2c) {collect_ms:.3f} ms, bootstrap and GAE "
        f"{gae_ms:.3f} ms, {n_passes} band passes (embed and gates + K11 + K13 + input-side "
        f"products + optimizer) {passes_ms:.3f} ms; one band's rnn_fused_grads {grads_ms:.3f} ms "
        f"[{kind}, {card}]")

    # Each kernel at the band shape, on the trajectory's data, beside its plain version.
    we, be, wi, bi, wh, bhn, wc, bc = dims.split(runner.params)
    x = ippo_rnn.band_slice(traj["obs"], *band).float()
    with torch.no_grad():
        iall = gru_embed_gates((we, be, wi, bi), x)[1].to(torch.bfloat16)
    advb = ippo_rnn.band_slice(adv, *band)
    a = dict(wh=wh, bhn=bhn, whead=wc, bhead=bc[0], iall=iall, done=traj["done"],
             h0=runner.carry, action=traj["action"], logp=traj["logp"], value=traj["value"],
             adv=adv, target=targets,
             stats=torch.stack([advb.mean(), 1.0 / (advb.std(correction=0) + 1e-8)]))
    fwd, loss, bwd = step.seq_fwd, step.loss_bwd, build_fused_gru_seq_bwd(dims)
    seq = (wh, bhn, iall, traj["done"], runner.carry)
    k11_ms, hseq = cuda_ms(lambda: fwd(*seq, *band), repeats=3)
    k11_plain_ms, _ = cuda_ms(lambda: fwd.plain(*seq, *band))
    dh = (torch.randn(hseq.shape, device=dev) * 1e-2).to(torch.bfloat16)
    k12_ms, _ = cuda_ms(lambda: bwd(*seq, hseq, dh, *band), repeats=3)
    k12_plain_ms, _ = cuda_ms(lambda: bwd.plain(*seq, hseq, dh, *band))
    largs = (wh, bhn, wc, bc[0], iall, traj["done"], runner.carry, hseq, traj["action"],
             traj["logp"], traj["value"], adv, targets, a["stats"], *band)
    k13_ms, _ = cuda_ms(lambda: loss(*largs), repeats=3)
    k13_plain_ms, _ = cuda_ms(lambda: loss.plain(*largs))
    _, _, _, k11_err, k12_err, k13_err = compare_gru_seq(dims, a, band, 43, fwd, bwd, loss,
                                                         what="K11-K13 at the main shape")
    log(f"phase 27 kernels at the band shape B={n_envs} band {band}: K11 "
        f"({k11_plan(dims, runner.carry.shape[1], band[1])}) {k11_ms:.3f} ms/launch "
        f"(plain {k11_plain_ms:.1f} ms, hseq max_abs_err {k11_err}); K12 {k12_ms:.3f} ms/launch "
        f"(plain {k12_plain_ms:.1f} ms, max_abs_err {k12_err}); K13 {k13_ms:.3f} ms/launch "
        f"(plain {k13_plain_ms:.1f} ms, max_abs_err {k13_err}) [{kind}, {card}]")
    # one more launch of each backward, its kernels between CUDA events
    for name, kernel, args in (("K13", loss, largs), ("K12", bwd, seq + (hseq, dh) + band)):
        total_ms, (_, split) = cuda_ms(lambda: kernel.timed(*args))
        log(f"phase 27 {name} split at the band shape, one timed launch: prologue "
            f"{split['prologue']:.3f} ms, sweep {split['sweep']:.3f} ms, dWh {split['wgrad']:.3f} "
            f"ms, reduction {split['reduce']:.3f} ms; {sum(split.values()):.3f} ms together, "
            f"{total_ms:.3f} ms around the call [{kind}, {card}]")
    b11, b12, b13 = seq_bounds(dims, a, band, hseq)
    return [
        kernel_entry("fused_gru_seq_fwd", "fused_gru_seq_fwd.cu", "rware_tpu/ops/pallas_gru.py:78",
                     launches["fused_gru_seq_fwd"], k11_err, k11_ms, k11_plain_ms, b11),
        kernel_entry("fused_gru_seq_bwd", "fused_gru_seq_bwd.cu",
                     "rware_tpu/ops/pallas_gru.py:172", launches["fused_gru_seq_bwd"], k12_err,
                     k12_ms, k12_plain_ms, b12),
        kernel_entry("fused_gru_loss_bwd", "fused_gru_loss_bwd.cu",
                     "rware_tpu/ops/pallas_gru.py:823", launches["fused_gru_loss_bwd"], k13_err,
                     k13_ms, k13_plain_ms, b13),
    ]


def phase28(dev, kind, card, n_envs=16384, rollout_len=128):
    """Recurrent MAPPO at full width, without and with two message bits."""
    import rware_tpu_torch
    from rware_tpu_torch.models import ippo, mappo

    for m in (0, 2):
        env = rware_tpu_torch.make("rware-tiny-2ag-v2", msg_bits=m)  # the card
        require(env.device.type == "cuda", f"make's default device is {env.device}")
        cfg = ippo.IPPOConfig(n_envs=n_envs, rollout_len=rollout_len, epochs=4, minibatches=4)
        n_passes = cfg.epochs * cfg.minibatches
        runner, dims, cdims = mappo.init_rnn_mappo_runner(env, cfg, seed=0)
        step = mappo.build_rnn_mappo_train_step(env, dims, cdims, cfg)
        counted = {"fused_collect_gru": step.collect, "fused_critic_values": step.critic_values,
                   "fused_gru_obs_fwd": step.gru_fwd, "fused_gru_obs_bwd": step.gru_bwd,
                   "fused_mappo_grads": step.critic_grads}
        want = {"fused_collect_gru": 3, "fused_critic_values": 3,
                "fused_gru_obs_fwd": 3 * n_passes, "fused_gru_obs_bwd": 3 * n_passes,
                "fused_mappo_grads": 3 * n_passes}
        params0 = {k: v.clone() for k, v in runner.params.items()}
        runner, _ = _time_learner(f"recurrent MAPPO M={m}", step, runner, counted, want, kind,
                                  card, cfg, phase=28)
        new, old = dims.split(runner.params["actor"]), dims.split(params0["actor"])
        moved = [float((x - y).abs().max()) for x, y in zip(new[:6], old[:6])]
        moved += [float((new[6][:, :dims.n_actions] - old[6][:, :dims.n_actions]).abs().max())]
        moved += [float((x - y).abs().max()) for x, y in
                  zip(cdims.split(runner.params["critic"]), cdims.split(params0["critic"]))]
        require(min(moved) > 0, f"recurrent MAPPO M={m} left a block unmoved: {moved}")
        value_moved = float((new[6][:, dims.n_actions] - old[6][:, dims.n_actions]).abs().max())
        require(value_moved == 0, f"the actor's local value head moved by {value_moved}: MAPPO's "
                                  f"value term is the critic's (vf_coef = 0 for the actor)")
        collect_ms, (states, new_carry, traj) = cuda_ms(lambda: step.rollout(runner))
        values_ms, values = cuda_ms(lambda: step.values(runner, traj))
        gae_ms, (obs, adv, targets) = cuda_ms(
            lambda: step.advantages(runner, states, traj, values))
        dataset = (traj["obs"], traj["done"], traj["action"], traj["logp"], values, adv, targets,
                   runner.carry) + ((traj["bits"],) if m else ())
        passes_ms, _ = cuda_ms(lambda: step.update(runner, dataset))
        band = (0, n_envs // cfg.minibatches)
        band_ms, _ = cuda_ms(lambda: step.band_grads(runner.params, dataset, band))
        log(f"phase 28 recurrent MAPPO M={m} breakdown of one update: collect (K2c"
            f"{' with K2b' if m else ''}) {collect_ms:.3f} ms, critic values (K6) "
            f"{values_ms:.3f} ms, bootstrap and GAE {gae_ms:.3f} ms, {n_passes} band passes "
            f"(K9 + actor loss + K10, band copy + K5, optimizer) {passes_ms:.3f} ms; one band's "
            f"gradients {band_ms:.3f} ms [{kind}, {card}]")


GYM_ENV = "rware-tiny-2ag-v2"
GYM_BATCH = 4096  # BASELINE's learning batch (BASELINE.md:203-305)
GYM_STEPS = 128
# The golden delivery-free scenario of phase 29 on tiny-2ag: agent 0 on shelf
# 0's rack cell, agent 1 on the highway; it picks up, carries, turns, bumps the
# wall, is refused a drop on the highway; agent 1 picks up a shelf and is
# refused a loaded move onto a standing shelf.  No agent reaches a goal, so no
# queue is resampled and two devices' generators cannot disagree.
GYM_SCRIPT = ([4, 1], [1, 2], [3, 1], [1, 3], [1, 1], [3, 0], [1, 4], [4, 2], [1, 1],
              [2, 1], [1, 4], [0, 1], [2, 1], [1, 0], [1, 0])


def gym_vector(env_id, num_envs, dev, have_gym, **overrides):
    """``gym.make_vec`` of the port's registered id on ``dev``, or without
    gymnasium the device program it runs (``core.host.HostVectorEnv``)."""
    import rware_tpu_torch
    from rware_tpu_torch.core.host import HostVectorEnv

    if have_gym:
        import gymnasium as gym

        return gym.make_vec(env_id, num_envs=num_envs, device=dev, **overrides)
    return HostVectorEnv(rware_tpu_torch.make(env_id, device=dev, **overrides), num_envs)


def random_gym_actions(rng, config, b):
    """(B, N) or (B, N, 1 + M) int32 actions from a numpy generator."""
    import numpy as np

    acts = rng.integers(0, 5, size=(b, config.n_agents), dtype=np.int32)
    if config.msg_bits:
        bits = rng.integers(0, 2, size=(b, config.n_agents, config.msg_bits), dtype=np.int32)
        acts = np.concatenate([acts[..., None], bits], axis=-1)
    return acts


def device_copies(fn):
    """(device-to-host copies, host-to-device copies, device events, device
    busy ms, wall ms, fn()) of one call, by torch.profiler's trace of the
    card; busy is the union of the device events' intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.name for e in dev_events]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev_events):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return (sum(n.startswith("Memcpy DtoH") for n in names),
            sum(n.startswith("Memcpy HtoD") for n in names), len(names), busy_us / 1e3,
            wall_ms, out)


def gym_scenario(config, dev):
    """Phase 29's golden delivery-free state on ``dev`` (a batch of one)."""
    from rware_tpu_torch.testing import DOWN, UP, make_state

    return make_state(config, [(1, 1, UP), (4, 3, DOWN)], queue=[0, 5], device=dev)


def batch_sizes(obs):
    """The leading sizes of every leaf of a batched observation tuple."""
    if isinstance(obs, dict):
        return {n for v in obs.values() for n in batch_sizes(v)}
    if isinstance(obs, (tuple, list)):
        return {n for v in obs for n in batch_sizes(v)}
    return {obs.shape[0]}


def phase29(dev, kind, card, n_envs=GYM_BATCH, n_steps=GYM_STEPS):
    """The Gym surface on the card: the vector env against the functional
    engine, the four observation types, one env on the card against the CPU,
    one device-to-host copy a step, the debug checks, and times.  Without
    gymnasium the classes' device programs (``core.host.HostVectorEnv``,
    ``HostEnv``) run alone."""
    import numpy as np
    import torch
    import rware_tpu_torch
    from rware_tpu_torch import debug
    from rware_tpu_torch.core.host import HostEnv, to_host
    from rware_tpu_torch.core.observations import build_global_layers_fn
    from rware_tpu_torch.core.state import state_field_names
    from rware_tpu_torch.rendering import Viewer
    from rware_tpu_torch.testing import UP, make_state
    from rware_tpu_torch.types import ObservationType

    try:
        import gymnasium  # noqa: F401
        from rware_tpu_torch import gym_adapter
        have_gym = True
        gym_adapter.register_all(force=True, image=True)
    except ImportError as e:
        have_gym = False
        log(f"phase 29: the Gym classes were not run on this machine ({e}); their "
            f"gymnasium-free device programs (core.host.HostVectorEnv, HostEnv), rendering "
            f"and debug were")

    def space_of(v):
        return getattr(v, "observation_space", None)

    def in_space(v, obs, b):
        space = space_of(v)
        return batch_sizes(obs) == {b} and (space is None or space.contains(obs))

    def one_env(d, **over):
        if have_gym:
            return gym_adapter.make_gym(GYM_ENV, device=d, **over)
        return HostEnv(rware_tpu_torch.make(GYM_ENV, device=d, **over))

    # 1. The vector env at full width against the functional engine with
    # NEXT_STEP autoreset on the card, from the same generator state; the
    # reference steps through debug.checked_step.
    venv = gym_vector(GYM_ENV, n_envs, dev, have_gym, max_steps=100)
    host = getattr(venv, "_host", venv)
    env = rware_tpu_torch.make(GYM_ENV, device=dev, max_steps=100)
    checked = debug.checked_step(env.step, env.config)
    rng = np.random.default_rng(0)
    obs, _ = venv.reset(seed=0)
    require(in_space(venv, obs, n_envs), "phase 29: reset obs outside observation_space")
    resets = 0
    for t in range(n_steps):
        state, prev = host.states, host.prev_done.clone()
        gen = torch.Generator(device=dev).set_state(host.generator.get_state())
        acts = random_gym_actions(rng, env.config, n_envs)
        obs, rew, term, trunc, info = venv.step(acts)
        err, res = checked(state, torch.from_numpy(acts).to(dev), gen)
        err.throw()
        fresh = env.reset_state(gen, n_envs)
        want = fresh.where(prev, res.state)
        bad = [f for f in state_field_names()
               if not torch.equal(getattr(host.states, f), getattr(want, f))]
        require(not bad, f"phase 29 step {t}: vector states differ from the engine's: {bad}")
        want_obs = torch.where(prev[:, None, None], env.observe(fresh), res.obs)
        keep = ~prev
        w_obs, w_rew, w_term, *w_info = to_host(
            want_obs, torch.where(keep[:, None], res.rewards, 0.0), res.done & keep,
            *(torch.where(keep, v, 0) for v in res.info.values()))
        require(np.array_equal(np.stack(obs, axis=1), w_obs), f"phase 29 step {t}: obs differ")
        require(np.array_equal(rew, w_rew) and rew.dtype == np.float32 and rew.shape
                == (n_envs, env.n_agents), f"phase 29 step {t}: rewards differ")
        require(np.array_equal(term, w_term) and not trunc.any(), f"phase 29 step {t}: done")
        require(all(np.array_equal(info[k], v) for k, v in zip(res.info, w_info)),
                f"phase 29 step {t}: info differs")
        if t % (n_steps // 4) == n_steps // 4 - 1:
            require(in_space(venv, obs, n_envs), f"phase 29 step {t}: obs outside the space")
        resets += int(prev.sum())
    require(resets >= n_envs, f"phase 29: only {resets} autoresets in {n_steps} steps")
    debug.validate_state(host.states, env.config)
    log(f"phase 29 vector env {GYM_ENV} B={n_envs} T={n_steps} (max_steps 100): states, obs, "
        f"rewards, done and info bit for bit the engine's with NEXT_STEP autoreset, {resets} "
        f"env resets, checked_step raised nothing, obs "
        f"{'in observation_space' if have_gym else 'of batch ' + str(n_envs)} on 4 sampled "
        f"steps [{kind}, {card}]")

    # 2. The four observation types with two message bits, B=1,024.
    for env_id, over in (("rware-tiny-2ag-v2", {}),
                         ("rware-tiny-2ag-v2", {"observation_type": ObservationType.DICT}),
                         ("rware-img-tiny-2ag-v2", {}), ("rware-imgdict-tiny-2ag-v2", {})):
        v = gym_vector(env_id, 1024, dev, have_gym, msg_bits=2, **over)
        cfg = getattr(v, "_host", v).env.config
        o, _ = v.reset(seed=1)
        ok = [in_space(v, o, 1024)]
        for _ in range(3):
            o, r, d, _, _ = v.step(random_gym_actions(rng, cfg, 1024))
            ok.append(in_space(v, o, 1024) and len(o) == 2)
            require(r.shape == (1024, 2) and np.isfinite(r).all(), f"phase 29 {env_id} rewards")
        require(all(ok), f"phase 29 {env_id} {over}: obs outside the space {ok}")
    log(f"phase 29 observation types FLATTENED, DICT, IMAGE, IMAGE_DICT with 2 message bits, "
        f"B=1024, a reset and 3 steps each: obs "
        f"{'in their observation_space' if have_gym else 'of batch 1024 (no gymnasium)'}")

    # 3. One env on the card against the CPU on the golden scenario.
    cfg = rware_tpu_torch.parse_env_id(GYM_ENV)
    outs = []
    for d in (dev, torch.device("cpu")):
        one = one_env(d, render_mode="rgb_array")
        one.reset(seed=0)
        one.state = gym_scenario(cfg, d)
        seq = []
        for acts in GYM_SCRIPT:
            out = one.step(acts)
            if have_gym:
                out += (one.render(), one.get_global_image(),
                        one.get_global_image(pad_to_shape=(2, 13, 12), recompute=True))
            else:
                out += (Viewer(cfg).frame(one.state),
                        to_host(build_global_layers_fn(cfg, (0, 5))(one.state)[0])[0])
            seq.append(out)
        outs.append(seq)
    for t, (a, b) in enumerate(zip(*outs)):
        require(all(np.array_equal(x, y) for x, y in zip(a[0], b[0])), f"phase 29 step {t}: obs")
        require(a[1] == b[1] and a[2] == b[2] and a[3] == b[3], f"phase 29 step {t}: rewards")
        require(all(np.array_equal(a[4][k], b[4][k]) for k in b[4]), f"phase 29 step {t}: info")
        require(int(a[4]["deliveries"]) == 0, f"phase 29 step {t}: a delivery in the scenario")
        require(all(x.tobytes() == y.tobytes() for x, y in zip(a[5:], b[5:])),
                f"phase 29 step {t}: frame or global image differs")
    log(f"phase 29 {'GymWarehouse' if have_gym else 'HostEnv'} on the card against the CPU, "
        f"the golden delivery-free scenario ({len(GYM_SCRIPT)} scripted steps): obs, rewards, "
        f"done and info equal, rgb frames and global images byte for byte; failed moves "
        f"{sum(int(x[4]['failed_moves']) for x in outs[0])}")

    # 4. One device-to-host copy a step.
    one = one_env(dev)
    one.reset(seed=0)
    one.step([1, 1])  # warm-up
    dtoh, htod, events, busy, wall, _ = device_copies(lambda: one.step([1, 4]))
    require(events > 0, "phase 29: torch.profiler traced no device event")
    require(dtoh == 1, f"phase 29: a one-env step made {dtoh} device-to-host copies")
    acts = random_gym_actions(rng, cfg, n_envs)
    dtoh_v, htod_v, events_v, busy_v, wall_v, _ = device_copies(lambda: venv.step(acts))
    require(events_v > 0, "phase 29: torch.profiler traced no device event")
    require(dtoh_v == 1, f"phase 29: a vector step made {dtoh_v} device-to-host copies")
    log(f"phase 29 copies by torch.profiler: {type(one).__name__}.step {dtoh} DtoH ({htod} HtoD, "
        f"{events} device events, device busy {busy:.3f} of {wall:.3f} ms profiled); "
        f"{type(venv).__name__}.step B={n_envs} {dtoh_v} DtoH ({htod_v} HtoD, {events_v} "
        f"device events, device busy {busy_v:.3f} of {wall_v:.3f} ms profiled) [{kind}, {card}]")

    # 5. checked_step's throw() on broken states on the card.
    steps = debug.checked_step(env._step_fn, env.config)
    noop = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    base = make_state(env.config, [(1, 1, UP), (2, 2, UP)], carrying=[0, -1], device=dev)
    broken = {"two agents share a cell after step": base.set_agent(1, x=1, y=1),
              "carried shelf not under its carrier": base.set_agent(0, x=0, y=0)}
    for message, state in broken.items():
        err, _ = steps(state, noop)
        try:
            err.throw()
        except debug.CheckError as e:
            require(message in str(e), f"phase 29: checked_step raised {e!r}, not {message!r}")
        else:
            raise AssertionError(f"phase 29: checked_step did not raise on: {message}")
    log("phase 29 debug: checked_step's throw() raised on two agents on one cell and on a "
        "carried shelf off its carrier; validate_state passed the vector env's states")

    # 6. Times, the host conversion included.
    times = []
    for name, over in (("FLATTENED", {}), ("DICT", {"observation_type": ObservationType.DICT})):
        v = gym_vector(GYM_ENV, n_envs, dev, have_gym, **over)
        v.reset(seed=2)
        batch = [random_gym_actions(rng, cfg, n_envs) for _ in range(64)]
        v.step(batch[0])
        torch.cuda.synchronize()
        start = time.perf_counter()
        for a in batch:
            v.step(a)
        sec = time.perf_counter() - start
        start = time.perf_counter()
        for k in range(10):
            v.reset(seed=k)
        reset_ms = (time.perf_counter() - start) / 10 * 1e3
        times.append(f"{name} {n_envs * len(batch) / sec:.6g} env-steps/s "
                     f"({sec / len(batch) * 1e3:.3f} ms a step), a reset {reset_ms:.3f} ms")
    one = one_env(dev)
    one.reset(seed=0)
    start = time.perf_counter()
    for t in range(200):
        one.step([t % 5, (t + 2) % 5])
    times.append(f"{type(one).__name__}.step {200 / (time.perf_counter() - start):.6g} steps/s")
    log(f"phase 29 times, host conversion included: {type(venv).__name__} {GYM_ENV} "
        f"B={n_envs}: " + "; ".join(times) + f" [{kind}, {card}]")


# K2d at SEAC A2C's shape (T=5): (env id, batch, message bits).  B=256 is
# train's default batch, 16,384 the training batch of the other phases;
# small-4ag takes a 4 x 4 cross grid in the update.
A2C_K2D_CASES = (("rware-tiny-2ag-v2", 256, 0), ("rware-tiny-2ag-v2", 16384, 0),
                 ("rware-small-4ag-v2", 4096, 0), ("rware-tiny-2ag-v2", 16384, 2))
A2C_LOSS_RTOL = 1e-4  # the update's loss terms, card against CPU
A2C_PARAM_LR_FRAC = 0.05  # of lr: every parameter after one step, card against CPU


def trace_busy(log_dir):
    """(device busy ms, traced window ms, K2d kernel events, kernel events)
    of the one Chrome trace ``profiling.TraceWindow`` wrote into
    ``log_dir``: busy is the union of the device events' intervals (kernels,
    copies, sets), the window from the first event's start to the last
    one's end."""
    import glob
    import os

    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    require(len(files) == 1, f"train --profile-dir wrote {files}, not one trace")
    with open(files[0]) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in device if e["cat"] == "kernel"]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    window_us = max(float(e["ts"]) + float(e["dur"]) for e in events) \
        - min(float(e["ts"]) for e in events)
    k2d = [e for e in kernels if "fused_collect_kernel" in e["name"]]
    return busy_us / 1e3, window_us / 1e3, len(k2d), len(kernels)


def phase30(dev, kind, card, n_envs=16384, rollout_len=5):
    """SEAC A2C (``--algo seac``): K2d at its shape against its plain
    version, the learner at full width with its update split, the update on
    the card against the CPU, and ``train --algo seac --profile-dir`` with
    the trace read; returns K2d's entry at A2C's shape."""
    import dataclasses
    import os
    import tempfile

    import torch
    import rware_tpu_torch
    from rware_tpu_torch import train
    from rware_tpu_torch.models import seac
    from rware_tpu_torch.models.ppo import AdamState, loss_grads

    errs = {}
    for env_id, b, m in A2C_K2D_CASES:
        overrides = {"msg_bits": m} if m else {}
        for deterministic in ((True, False) if b == 256 else (False,)):
            _, _, _, err, collect = compare_k2d(env_id, dev, b, rollout_len, deterministic, 5,
                                                **overrides)
            errs[env_id, b, m] = err
            log(f"phase 30 K2d{' with K2b' * bool(m)} {env_id} M={m} B={b} T={rollout_len} "
                f"deterministic={deterministic}: obs/reward/done/state/actions"
                f"{'/bits' * bool(m)} exact, value/logp err {err} ({tile_note(collect, b)}) "
                f"[{kind}, {card}]")

    entry = None
    for env_id, b, m in (("rware-tiny-2ag-v2", n_envs, 0), ("rware-small-4ag-v2", 4096, 0),
                         ("rware-tiny-2ag-v2", n_envs, 2)):
        # no device named: the card
        env = rware_tpu_torch.make(env_id, **({"msg_bits": m} if m else {}))
        require(env.device.type == "cuda", f"make's default device is {env.device}")
        cfg = seac.SEACConfig(n_envs=b, rollout_len=rollout_len)
        runner, dims = seac.init_seac(env, cfg, seed=0)
        step = seac.build_seac_train_step(env, dims, cfg)
        params0 = runner.params.clone()
        name = env_id.replace("rware-", "").replace("-v2", "")
        # 20 steps from a reset see few deliveries (3 in 16,384 envs of random
        # tiny-2ag moves), so no reward is required: the update's check against
        # the CPU below holds the learner's output
        runner, update_ms = _time_learner(
            "SEAC A2C", step, runner, {"fused_collect_per_agent": step.collect},
            {"fused_collect_per_agent": 3}, kind, card, cfg, phase=30,
            need_reward=False)
        launches = step.collect.launches
        moved = [float((a - c).abs().max()) for i in range(env.n_agents)
                 for a, c in zip(dims.split(runner.params[i]), dims.split(params0[i]))]
        require(min(moved) > 0, f"the SEAC A2C update left a block unmoved: {moved}")

        # One update, phase by phase.
        collect_ms, (states, traj) = cuda_ms(lambda: step.rollout(runner))
        obs_ms, obs = cuda_ms(lambda: step.policy_obs(states))
        grads_ms, (grads, metrics) = cuda_ms(lambda: loss_grads(
            lambda p: seac.seac_a2c_loss(cfg, dims, p, traj, obs), runner.params))
        opt_ms, _ = cuda_ms(lambda: seac.seac_optimizer_step(cfg, runner.params, grads,
                                                             runner.opt_state))
        log(f"phase 30 SEAC A2C {name} M={m} B={b} T={rollout_len} breakdown of one update: "
            f"collect (K2d{' with K2b' * bool(m)}) {collect_ms:.3f} ms, observations after it "
            f"{obs_ms:.3f} ms, the {env.n_agents} x {env.n_agents} cross forwards, bootstrap, "
            f"cross GAE and loss with autograd {grads_ms:.3f} ms, clip + Adam {opt_ms:.3f} ms "
            f"[{kind}, {card}]")
        if entry is not None:
            continue

        # The update on the card against the same update on the CPU.
        (p_dev, _), m_dev = step.update(runner, traj, obs)
        cpu_runner = dataclasses.replace(
            runner, params=runner.params.cpu(),
            opt_state=AdamState(runner.opt_state.count, runner.opt_state.mu.cpu(),
                                runner.opt_state.nu.cpu()))
        (p_cpu, _), m_cpu = step.update(cpu_runner, {k: v.cpu() for k, v in traj.items()},
                                        obs.cpu())
        rel = 0.0
        for k in m_cpu:
            a, c = float(m_dev[k]), float(m_cpu[k])
            require(abs(a - c) <= A2C_LOSS_RTOL * abs(c) + 1e-6,
                    f"SEAC A2C update: {k} card {a} CPU {c}")
            rel = max(rel, abs(a - c) / max(abs(c), 1e-12))
        diff = float((p_dev.cpu() - p_cpu).abs().max())
        require(diff <= A2C_PARAM_LR_FRAC * cfg.lr,
                f"SEAC A2C update: a parameter {diff / cfg.lr} lr from the CPU's, more than "
                f"{A2C_PARAM_LR_FRAC} lr")
        log(f"phase 30 SEAC A2C update card against CPU on one K2d trajectory (B={b}): loss "
            f"terms within rtol {A2C_LOSS_RTOL} (largest relative difference {rel:.3g}; "
            f"{ {k: round(float(v), 6) for k, v in m_dev.items()} }), "
            f"every parameter within {A2C_PARAM_LR_FRAC} lr (max |diff| {diff:.4g} = "
            f"{diff / cfg.lr:.4f} lr) [{kind}, {card}]")

        # K2d at this shape, beside its plain version.
        policies = seac.seac_policies_of(dims, runner.params)
        args = (runner.env_states, policies, 7)
        k_ms, _ = cuda_ms(lambda: step.collect(*args), repeats=5)
        plain_ms, _ = cuda_ms(lambda: step.collect.plain(*args))
        k_bound = collect_per_agent_bound(dims, states, traj, runner.params,
                                          b * rollout_len * env.n_agents)
        log(f"phase 30 K2d at A2C's shape B={b} T={rollout_len}: {k_ms:.3f} ms/launch (plain "
            f"{plain_ms:.1f} ms), bound {k_bound[0]:.4f} ms ({k_bound[1]}), "
            f"{k_ms / update_ms:.1%} of an update [{kind}, {card}]")
        entry = kernel_entry("fused_collect_per_agent (SEAC A2C, T=5)", "collect_mlp.cuh",
                             "rware_tpu/ops/pallas_rollout.py:1798", launches,
                             errs["rware-tiny-2ag-v2", b, 0], k_ms, plain_ms, k_bound)

    # The entry point, with a torch.profiler window over updates [3, 6).
    with tempfile.TemporaryDirectory() as tmp:
        for b in (256, n_envs):
            prof = os.path.join(tmp, str(b))
            start = time.perf_counter()
            out = train.main(["--algo", "seac", "--device", "cuda", "--n-envs", str(b),
                              "--updates", "8", "--log-every", "4", "--profile-dir", prof])
            wall_s = time.perf_counter() - start
            busy, window, k2d, n_kernels = trace_busy(prof)
            require(n_kernels > 0, f"train --profile-dir B={b}: no CUDA kernel in the trace")
            require(k2d == 3, f"train --profile-dir B={b}: {k2d} K2d kernels in 3 traced updates")
            log(f"phase 30 train --algo seac B={b} T=5, 8 updates ({wall_s:.2f} s wall, the "
                f"last window {out['env_steps_per_s']:.4g} env-steps/s), traced updates 3-5: "
                f"{n_kernels} kernels, {k2d} of them K2d's, device busy {busy:.3f} of "
                f"{window:.3f} ms traced ({busy / window:.1%}) [{kind}, {card}]")
    return [entry]


# ---- phase 31: distribution ---------------------------------------------------

DP_GLOBAL = 16384  # IPPO's global batch across the ranks (phase 8's)
DP_SMALL = (2048, 32)  # the other learners' global batch and rollout
DP_LO = 8192  # the first global row of the shard in (a)


def digest(tree) -> str:
    """sha256 of every tensor of ``tree`` (``rware_tpu_torch.testing.digest``)."""
    from rware_tpu_torch.testing import digest as tree_digest

    return tree_digest(tree)


def _rows(tree, lo, hi, axis):
    from rware_tpu_torch.parallel.sharding import tree_map

    return tree_map(lambda x: x.narrow(axis, lo, hi - lo), tree)


def _offset_case(what, launch, plain, states, lo, hi, h0=None):
    """``launch`` on rows [lo, hi) with ``env_offset=lo`` against the global
    launch's rows (bit for bit, every output) and against the plain version
    on those rows: exact where the result feeds back (K1: everything;
    collectors: obs, reward, done, the state, the carry within a bf16 step
    and actions by phase 4's agreement, value and logp within 2e-2)."""
    import torch

    args = () if h0 is None else (h0,)
    part = _rows(states, lo, hi, 0)
    pargs = () if h0 is None else (h0[lo:hi],)
    whole = launch(states, *args)
    got = launch(part, *pargs, env_offset=lo)
    ref = plain(part, *pargs, env_offset=lo)
    torch.cuda.synchronize()
    for i, (w, g) in enumerate(zip(whole, got)):
        axis = 1 if isinstance(w, dict) else 0  # the trajectory is (T, B, ...)
        require(digest(_rows(w, lo, hi, axis)) == digest(g), f"{what}: output {i} of the "
                f"shard != the global launch's rows")
    if not isinstance(whole[-1], dict):  # K1: the plain version is exact
        require(digest(got) == digest(ref), f"{what}: shard kernel != plain")
        return 0.0
    kt, pt = got[-1], ref[-1]
    for k in ("obs", "reward", "done"):
        require(torch.equal(kt[k], pt[k]), f"{what}: {k} differs from plain")
    require(not state_diff(got[0], ref[0]), f"{what}: final state differs from plain")
    agree = float((kt["action"] == pt["action"]).float().mean())
    err = max(float((kt[k] - pt[k]).abs().max()) for k in ("value", "logp"))
    require(agree >= ACTION_AGREEMENT and err <= VALUE_LOGP_ATOL,
            f"{what}: plain agreement {agree}, value/logp err {err}")
    if h0 is not None:
        h_ok = float(((got[1].float() - ref[1].float()).abs() <= BF16_STEP).float().mean())
        require(h_ok >= ACTION_AGREEMENT, f"{what}: carry within a bf16 step {h_ok}")
    return err


def phase31a(dev):
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models import ActorCritic
    from rware_tpu_torch.models.networks import init_recurrent_actor_critic
    from rware_tpu_torch.ops.fused_rollout import (
        build_fused_collect,
        build_fused_collect_gru,
        build_fused_collect_gru_per_agent,
        build_fused_rollout,
    )
    from rware_tpu_torch.parallel import batched_reset

    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=dev)
    out = []
    states, _ = batched_reset(env, 31, 65536)
    roll = build_fused_rollout(env.config, 256)
    _offset_case("K1 B=65536 T=256", lambda s, **kw: roll(s, 7, **kw),
                 lambda s, **kw: roll.plain(s, 7, **kw), states, DP_LO, 2 * DP_LO)
    out.append("K1 B=65,536 T=256")
    states, _ = batched_reset(env, 32, 16384)
    torch.manual_seed(31)
    policy = ActorCritic(env.config.policy_obs_length, hidden=(128, 128)).to(dev)
    collect = build_fused_collect(env.config, 128, hidden=(128, 128))
    err = _offset_case("K2a B=16384 T=128", lambda s, **kw: collect(s, policy, 8, **kw),
                       lambda s, **kw: collect.plain(s, policy, 8, **kw), states, DP_LO,
                       2 * DP_LO)
    out.append(f"K2a B=16,384 T=128 (plain value/logp err {err:.3g})")
    b, t = DP_SMALL
    states, _ = batched_reset(env, 33, b)
    gen = torch.Generator().manual_seed(31)
    h0 = (torch.rand((b, env.n_agents, 128), generator=gen) * 2 - 1).to(torch.bfloat16).to(dev)
    nets = [init_recurrent_actor_critic(env.config.policy_obs_length, 5, 128, 128, (31, i))
            .to(dev) for i in range(env.n_agents)]
    for name, build, pol in (("K2c", build_fused_collect_gru, nets[0]),
                             ("K2d'", build_fused_collect_gru_per_agent, nets)):
        collect = build(env.config, t, (128, 128))
        err = _offset_case(f"{name} B={b} T={t}", lambda s, h, **kw: collect(s, pol, 9, h, **kw),
                           lambda s, h, **kw: collect.plain(s, pol, 9, h, **kw), states,
                           b // 2, b, h0)
        out.append(f"{name} B={b:,} T={t} (plain value/logp err {err:.3g})")
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _timed_updates(step, runner, n):
    """Wall milliseconds per update over ``n`` more updates from ``runner``."""
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        runner, _ = step(runner)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / n


# phase 31b's learners through a world-1 NCCL mesh, (name, config fields): IPPO
# and SEAC-PPO at phases 8's and 17's shape, SEAC A2C at phase 30's
DP_WORLD1 = (("ippo", dict(n_envs=DP_GLOBAL, rollout_len=128, epochs=4, minibatches=4)),
             ("seac", dict(n_envs=DP_GLOBAL, rollout_len=128, epochs=4, minibatches=4)),
             ("seac_a2c", dict(n_envs=DP_GLOBAL, rollout_len=5)))


def _world1_case(name, cfg, env, mesh, dev, kind, card):
    """One learner through the world-1 mesh against the run without:
    bit for bit over 3 updates, its all-reduces counted, ms per update (mesh,
    plain, plain, mesh) and its collectives alone.  Returns the log line."""
    import torch
    from rware_tpu_torch.checkpoint import pack
    from rware_tpu_torch.testing import dp_learner, dp_run

    runs = {}
    for which, m in (("mesh", mesh), ("plain", None)):
        runner, step = dp_learner(name, env, cfg, 21, m)
        runs[which] = (dp_run(step, runner, 3, m), step)
    a, b = runs["mesh"][0], runs["plain"][0]
    # mesh, plain, plain, mesh: 3 updates each from the checked runners
    times = {"mesh": [], "plain": []}
    for which in ("mesh", "plain", "plain", "mesh"):
        out, step = runs[which]
        times[which].append(_timed_updates(step, out["runner"], 3))
    ms_mesh = sum(times["mesh"]) / 2
    require(digest(a["traj"]) == digest(b["traj"]), f"31b {name}: the collects differ")
    require(digest(pack(a["runner"])) == digest(pack(b["runner"]))
            and a["metrics"] == b["metrics"],
            f"31b {name}: the world-1 mesh run != the run without a mesh")
    passes = getattr(cfg, "epochs", 1) * getattr(cfg, "minibatches", 1)
    per_update = 2 if name == "seac_a2c" else passes + 1
    require(a["collect_counts"]["all_reduce"] == 0
            and all(c["all_reduce"] == per_update for c in a["update_counts"]),
            f"31b {name}: collectives {a['collect_counts']} / {a['update_counts']}")
    if name == "seac":
        require(a["launches"] == b["launches"] == {"collect": 3, "grads": 3 * passes},
                f"31b seac: launches {a['launches']} / {b['launches']}")
    # the collectives alone: per pass one packed float32 all-reduce of the
    # gradients and four metrics; one float64 all-reduce (IPPO: the reward
    # sums; SEAC-PPO: every window's moments and the sums; A2C: the sums)
    grads = (torch.zeros(a["runner"].params.numel(), device=dev), torch.zeros(4, device=dev))
    sums = (torch.zeros((passes if name == "seac" else 0, 3), dtype=torch.float64, device=dev),
            (torch.zeros((), device=dev), torch.zeros((), dtype=torch.int64, device=dev)))

    def collectives():
        for _ in range(passes):
            mesh.all_reduce_mean(grads)
        mesh.psum(sums)

    collectives()
    coll_ms, _ = cuda_ms(collectives, repeats=10)
    torch.cuda.synchronize()
    start = time.perf_counter()
    collectives()  # the host's time to issue them, without waiting for the device
    host_ms = (time.perf_counter() - start) * 1e3
    torch.cuda.synchronize()
    shape = f"B={cfg.n_envs} T={cfg.rollout_len}" + (f" E={cfg.epochs} M={cfg.minibatches}"
                                                     if passes > 1 else "")
    return (f"{name} tiny-2ag {shape}: bit-equal to the run without a mesh over 3 updates; "
            f"all-reduces {per_update} an update, 0 in the collect"
            + (f"; launches an update K2d 1, K8 {passes}" if name == "seac" else "")
            + f"; ms/update in the order timed: mesh {times['mesh'][0]:.3f}, plain "
            f"{times['plain'][0]:.3f}, plain {times['plain'][1]:.3f}, mesh {times['mesh'][1]:.3f}"
            f" (mesh {100 * (ms_mesh / (sum(times['plain']) / 2) - 1):+.2f}%); the {per_update} "
            f"collectives alone {coll_ms:.3f} ms "
            f"({100 * coll_ms / ms_mesh:.2f}% of an update; issued by the host in "
            f"{host_ms:.3f} ms; packed gradient {4 * (grads[0].numel() + 4)} bytes) "
            f"[{kind}, {card}]")


def phase31b(dev, kind, card):
    """World size 1 under NCCL: IPPO, SEAC-PPO (K2d + K8) and SEAC A2C
    through the mesh equal the same learners without."""
    import torch.distributed as dist
    import rware_tpu_torch
    from rware_tpu_torch.distributed import initialize
    from rware_tpu_torch.parallel.sharding import make_mesh
    from rware_tpu_torch.testing import dp_config

    rank_world = initialize(f"localhost:{_free_port()}", 1, 0, device=dev)
    require(rank_world == (0, 1) and dist.get_backend() == "nccl", f"initialize: {rank_world}")
    mesh = make_mesh(device=dev)
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=dev)
    lines = [_world1_case(name, dp_config(name, **fields), env, mesh, dev, kind, card)
             for name, fields in DP_WORLD1]
    dist.destroy_process_group()
    log(f"phase 31b NCCL world 1 through the mesh: {' | '.join(lines)}")


DP_TASK = {"kind": "learner", "env_id": "rware-tiny-2ag-v2", "seed": 31, "hidden": 128,
           "digest": True}


def dp_tasks():
    """Phase 31c's learner tasks (``testing.dp_task``): IPPO at the main
    shape for 3 updates, the other mesh learners at DP_SMALL for one, and
    the learners JAX only places on a mesh (``testing.DP_PLACED``) at
    DP_SMALL (SEAC A2C at T=5, SEAC-PPO's flat learner with two message
    bits) for one."""
    from rware_tpu_torch.testing import DP_LEARNERS, DP_PLACED

    big = dict(n_envs=DP_GLOBAL, rollout_len=128, epochs=4, minibatches=4)
    small = dict(n_envs=DP_SMALL[0], rollout_len=DP_SMALL[1], epochs=4, minibatches=4)
    placed = [dict(DP_TASK, name=name, learner=name, n_updates=1,
                   cfg=dict(small, rollout_len=5) if name == "seac_a2c" else small,
                   env_overrides={"msg_bits": 2} if name == "seac_flat" else {})
              for name in DP_PLACED]
    return ([dict(DP_TASK, name="ippo", learner="ippo", cfg=big, n_updates=3)]
            + [dict(DP_TASK, name=name, learner=name, cfg=small, n_updates=1)
               for name in DP_LEARNERS[1:] if name not in DP_PLACED]
            + placed)


# The learners whose collect is torch ops on the card (JAX's XLA collect): cuBLAS's
# float32 products depend on the batch's shape, so a rank's trajectory is held bit
# for bit to the emulated rank's (the same shapes) and to the global collect's rows
# within bounds (phase 33); on the CPU tests/test_torch_dp_train.py holds them equal.
TORCH_COLLECT = ("mappo_plain", "seac_gru_plain")
# Phase 31d's ``train`` arguments; its unbroken run in this process drops the first two
TORCHRUN_BASE = ["--distributed", "--mesh", "--device", "cuda", "--n-envs", "4096",
                 "--checkpoint-every", "2", "--log-every", "2"]
PLACED_PARAM_LR_FRAC = 0.05  # of lr * P: the parameters, two ranks against one rank
PLACED_METRIC_TOL = dict(rtol=1e-2, atol=1e-4)  # the metrics, two ranks against one rank


def _placed_check(name, ranks, whole, passes):
    """Two ranks of a learner with whole-batch statistics against the
    one-rank run of the same global batch on the card, within the CPU tests'
    tolerances (``tests/test_torch_dp_placement.py``: parameters within
    0.05 * lr * P, rtol 1e-3; metrics rtol 1e-2, atol 1e-4); K8's launches
    from its counter.  Returns the log's words for it."""
    import torch

    lr, p = 3e-4, passes if name != "seac_a2c" else 1
    want = whole["params"].float()
    worst = 0.0
    for r, got in enumerate(ranks):
        err = (got["params"].float() - want).abs()
        bound = PLACED_PARAM_LR_FRAC * lr * p + 1e-3 * want.abs()
        worst = max(worst, float((err / bound).max()))
        require(bool((err <= bound).all()), f"31c {name} rank {r}: parameters "
                f"{float(err.max())} from the one-rank update")
        for k, v in got["metrics"][0].items():
            w = whole["metrics"][0][k]
            require(abs(v - w) <= PLACED_METRIC_TOL["atol"] + PLACED_METRIC_TOL["rtol"] * abs(w),
                    f"31c {name} rank {r}: metric {k} {v} != the one-rank {w}")
        if name == "seac":
            require(got["launches"].get("grads") == passes == whole["launches"]["grads"],
                    f"31c seac rank {r}: K8 launches {got['launches']}, not {passes}")
    return (f"{name} parameters within {worst:.3f} of the bound"
            + (f", K8 {passes} launches an update on each rank" if name == "seac" else ""))


def phase31c(dev, kind, card):
    """Two gloo ranks on the one card against the in-process emulation, and
    per-rank checkpoints of two IPPO updates against the same two updates
    unbroken."""
    import os
    import tempfile

    import torch
    from rware_tpu_torch.testing import DP_PLACED, dp_results, dp_spawn, dp_task, emulate_mesh

    start = time.perf_counter()
    learners = dp_tasks()
    small = learners[1]["cfg"]
    ckpt = dict(DP_TASK, kind="checkpoint", name="checkpoint", cfg=small, n_updates=2)
    unbroken = dict(ckpt, kind="learner", name="unbroken")
    with tempfile.TemporaryDirectory(prefix="dp31-") as tmp:
        procs = dp_spawn((sys.executable, os.path.abspath(__file__), "--dp-rank"),
                         learners + [ckpt], 2, tmp, dev)
        try:
            emulated = emulate_mesh(lambda mesh: {t["name"]: dp_task(t, mesh, dev)
                                                  for t in learners + [unbroken]}, 2, dev)
            whole = {t["name"]: dp_task(dict(t, digest=False), None, dev) for t in learners}
        except BaseException:
            for p in procs:
                p.kill()
            raise
        res = dp_results(procs, learners + [ckpt], tmp, timeout=900)
    torch.cuda.synchronize()
    lines, placed = [], []
    for task in learners:
        name, cfg = task["name"], task["cfg"]
        passes = cfg["epochs"] * cfg["minibatches"]
        per_update = 2 if name == "seac_a2c" else passes + 1
        b = cfg["n_envs"] // 2
        ranks = res[name]
        for r in range(2):
            got, emu = ranks[r], emulated[r][name]
            if name in TORCH_COLLECT:  # the global rows: phase 33, within their bounds
                require(got["traj"] == emu["traj"], f"31c {name} rank {r}: trajectory != the "
                        "emulated rank's")
            else:
                rows = {k: v[:, r * b:(r + 1) * b] for k, v in whole[name]["traj"].items()}
                require(got["traj"] == digest(rows), f"31c {name} rank {r}: trajectory != its "
                        "rows of the global collect")
            require(got["runner"] == emu["runner"] and got["metrics"] == emu["metrics"],
                    f"31c {name} rank {r}: != the in-process emulation")
            require(got["collect_counts"]["all_reduce"] == 0
                    and all(c["all_reduce"] == per_update for c in got["update_counts"]),
                    f"31c {name} rank {r}: collectives {got['collect_counts']} "
                    f"{got['update_counts']}")
        require(ranks[0]["replicated"] == ranks[1]["replicated"],
                f"31c {name}: the ranks' parameters differ")
        lines.append(f"{name} B={cfg['n_envs']} T={cfg['rollout_len']} x{task['n_updates']}")
        if name in DP_PLACED:  # whole-batch statistics: the one-rank update of the batch
            placed.append(_placed_check(name, ranks, whole[name], passes))
    files = sorted(f"{s}.rank{r}-of2.pt" for s in (1, 2) for r in (0, 1))
    for r, out in enumerate(res["checkpoint"]):
        require(out["steps"] == [1, 2] and sorted(out["files"]) == files,
                f"31c checkpoint rank {r}: steps {out['steps']}, files {out['files']}")
        require("this run has world size 1" in out["refused"],
                f"31c checkpoint rank {r}: a restore at world size 1 was not refused")
        require(out["restored"] == out["saved"] == emulated[r]["unbroken"]["runner"],
                f"31c checkpoint rank {r}: the restored shard != the unbroken emulated run")
    log(f"phase 31c gloo, 2 ranks on one card: {'; '.join(lines)}: each rank's trajectory = "
        f"its rows of the global collect ({', '.join(TORCH_COLLECT)}: = the emulated rank's), "
        f"parameters bit-equal across ranks and to the "
        f"in-process emulation, E*M+1 all-reduces an update (SEAC A2C 2), the collectives on "
        f"CUDA tensors; the learners JAX only places on a mesh against the one-rank update of "
        f"the global batch on the card: {'; '.join(placed)}; "
        f"IPPO B={small['n_envs']} x2 saved per rank ({', '.join(files)}) and restored = the "
        f"unbroken emulated run bit for bit, a world-1 restore refused; "
        f"{time.perf_counter() - start:.1f} s [{kind}, {card}]")


def phase31d_start(tmp):
    """Phase 31d's two torchrun launches (4 updates with a checkpoint every 2,
    then ``--resume`` to 6) into ``tmp``, one after the other in a thread, so
    that they run beside phase 31c, which times nothing; returns (the thread,
    {launch: (rc, stdout, stderr)}, the launches' processes)."""
    import os
    import threading

    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    outs, procs = {}, []

    def torchrun(*args):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1",
               "--master-port", str(_free_port()), "-m", "rware_tpu_torch.train", *TORCHRUN_BASE,
               *args]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=env)
        procs.append(proc)
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            return -9, out, "timed out after 600 s\n" + err
        return proc.returncode, out, err

    def run():
        outs["first"] = torchrun("--updates", "4", "--checkpoint-dir", f"{tmp}/a")
        if outs["first"][0] == 0:
            outs["resumed"] = torchrun("--updates", "6", "--resume", "--checkpoint-dir",
                                       f"{tmp}/a")

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, outs, procs


def phase31d_stop(launches):
    """Kill phase 31d's launches still running and wait for the thread."""
    thread, _, procs = launches
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
    thread.join()


def phase31d(kind, card, tmp, launches, start):
    """``train.main`` unbroken for 6 updates in this process against phase
    31d's torchrun launches (``phase31d_start``), which ``--resume``'d to 6."""
    import torch
    from rware_tpu_torch import train

    train.main(TORCHRUN_BASE[2:] + ["--updates", "6", "--checkpoint-dir", f"{tmp}/b"])
    thread, outs, _ = launches
    thread.join(timeout=900)
    require(not thread.is_alive(), "31d: the torchrun launches ran past 900 s")
    for name in ("first", "resumed"):
        require(name in outs, f"31d: no {name} launch ({outs})")
        rc, out, err = outs[name]
        require(rc == 0, f"31d {name}: rc {rc}\n{out[-2000:]}\n{err[-3000:]}")
    a, b = (torch.load(f"{tmp}/{d}/runner/6.pt", weights_only=True) for d in "ab")
    require("distributed: process 0/1" in outs["first"][1]
            and "resumed from update 4" in outs["resumed"][1],
            "31d: the runs did not say what they did")
    require(digest(a) == digest(b), "31d: the resumed run != the unbroken run")
    log(f"phase 31d torchrun --nproc-per-node 1 train --distributed --mesh (NCCL, world 1): 4 "
        f"updates, --resume to 6 = an unbroken 6-update run of train.main bit for bit; "
        f"{time.perf_counter() - start:.1f} s from the first launch, beside phase 31c "
        f"[{kind}, {card}]")


def phase31(dev, kind, card):
    import tempfile

    start = time.perf_counter()
    cases = phase31a(dev)
    log(f"phase 31a env_offset: {'; '.join(cases)}, rows [{DP_LO}, {2 * DP_LO}) of K1 and "
        f"K2a, the second half of K2c and K2d': = the global launch's rows bit for bit and = "
        f"the plain versions "
        f"({time.perf_counter() - start:.1f} s) [{kind}, {card}]")
    phase31b(dev, kind, card)
    with tempfile.TemporaryDirectory(prefix="dp31d-") as tmp:
        start = time.perf_counter()
        launches = phase31d_start(tmp)
        try:
            phase31c(dev, kind, card)
            phase31d(kind, card, tmp, launches, start)
        finally:
            phase31d_stop(launches)


# Phase 32: the long-observation ids (sensor range 4 and 5, ``register_full``)
# on the fused collectors' new routes.  (env id, overrides, envs, steps): K2a's
# device-memory weight route (with K2b and K2e) compared at 1,000 envs, a
# ragged last tile, and timed at the training batch; K2d and K2d′ with the
# observation tile in chunks.
LONG_K2A = ("rware-5s-tiny-2ag-v2", {}, 16384, 128)
LONG_K2A_MODES = (("mlp", "rware-4s-tiny-2ag-v2", {"msg_bits": 2}),
                  ("mlp", "rware-img-5s-tiny-2ag-v2", {}),
                  ("mlp", "rware-imgdict-5s-tiny-2ag-v2", {}))
LONG_MODES_T = 32  # steps of the cases off the kernel line: their plain versions are launch-bound
LONG_COMPARE_B = 1000
# (env id, overrides, envs, steps): the kernel line's case (17 agents, M=0;
# 16 agents, M=0 for K2d′) at T=128, the others at T=32, as their plain
# versions take about 85 ms a step
LONG_K2D = tuple((f"rware-5s-tiny-{n}ag-v2", {"msg_bits": m}, 1024, 128 if (n, m) == (17, 0)
                  else LONG_MODES_T) for n in (17, 19) for m in (0, 2))
LONG_K2DP = tuple(("rware-5s-tiny-16ag-v2", {"msg_bits": m}, 1024, LONG_MODES_T if m else 128)
                  for m in (0, 2))
# The chunked image instantiations: K2d′ on img-5s at 19 agents (its plan's
# chunks) and K2d on imgdict-tiny-2ag with chunks of 32 forced (no registered
# id needs them at hidden (128, 128)); (kind, env id, forced chunk, envs, steps)
LONG_IMAGE = (("gru_per_agent", "rware-img-5s-tiny-19ag-v2", None, 256, 32),
              ("mlp_per_agent", "rware-imgdict-tiny-2ag-v2", 32, 1000, 32))
LONG_SEAC_B = 1024  # SEAC-PPO at 17 agents (chunked K2d + 16 x K8)
LONG_SEAC_GRU_B = 256  # recurrent SEAC-PPO at 16 agents (chunked K2d′): its torch replay is N^2


def long_case(kind, env_id, overrides, b, seed, dev):
    """(env, collector, launch arguments) of collector ``kind`` (``image_policy``'s
    kinds) on ``b`` envs of ``env_id`` reset from ``seed``, a network of hidden
    (128, 128) a stack, biases off zero, and for the GRU a random nonzero carry."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.ops import fused_rollout as fr
    from rware_tpu_torch.parallel import batched_reset

    env = rware_tpu_torch.make(env_id, device=dev, **overrides)
    states, _ = batched_reset(env, seed, b)
    build = {"mlp": fr.build_fused_collect, "gru": fr.build_fused_collect_gru,
             "mlp_per_agent": fr.build_fused_collect_per_agent,
             "gru_per_agent": fr.build_fused_collect_gru_per_agent}[kind]
    args = (states, image_policy(kind, env.config, seed, dev), seed + 1)
    if kind.startswith("gru"):
        gen = torch.Generator().manual_seed(seed)
        h0 = torch.rand((b, env.n_agents, 128), generator=gen) * 2 - 1
        args += (h0.to(torch.bfloat16).to(dev),)
    return env, build, args


def check_collect(what, env, out, plain, actions_exact=True, first=None):
    """A collector launch's outputs ``out`` against its plain version's
    ``plain`` on the same inputs, by phases 4, 15, 18, 21 and 24's rules: obs,
    rewards, done, bits, the final state and the carry bit for bit, every
    action too unless ``actions_exact`` is False (K2a's rule: 99.9%), value
    and logp within 2e-2; ``first``, an earlier launch's outputs, bit-equal to
    ``out``.  Returns max |value/logp error|."""
    import torch

    *k_state, k_traj = out
    *p_state, p_traj = plain
    for a, b in (((first, out),) if first is not None else ()) + ((out, plain),):
        same = a is first
        tag = "two launches" if same else "kernel != plain"
        require(not state_diff(a[0], b[0]), f"{what}: {tag}: final state differs")
        if len(a) == 3:
            require(torch.equal(a[1], b[1]), f"{what}: {tag}: the new carry differs")
        exact = ("obs", "reward", "done") + (("bits",) if "bits" in a[-1] else ()) \
            + (("action",) if actions_exact or same else ())
        for k in (a[-1] if same else exact):
            require(torch.equal(a[-1][k], b[-1][k]), f"{what}: {tag}: {k} differs")
    agree = float((k_traj["action"] == p_traj["action"]).float().mean())
    require(agree >= ACTION_AGREEMENT, f"{what}: action agreement {agree}")
    err = max(float((k_traj[k] - p_traj[k]).abs().max()) for k in ("value", "logp"))
    require(err <= VALUE_LOGP_ATOL, f"{what}: value/logp err {err}")
    for k, v in k_traj.items():
        require(not v.is_floating_point() or bool(torch.isfinite(v.float()).all()),
                f"{what}: non-finite {k}")
    check_invariants(env, k_state[0])
    return err


def route_check(what, env, collect, args, actions_exact=True):
    """The kernel launched twice (the second timed) and its plain version
    (timed) on the same inputs, held by ``check_collect``; the two launches
    bit-equal.  Returns (ms, plain ms, max |value/logp error|, the timed
    launch's outputs)."""
    first = collect(*args)
    k_ms, out = cuda_ms(lambda: collect(*args))
    p_ms, plain = cuda_ms(lambda: collect.plain(*args))
    return k_ms, p_ms, check_collect(what, env, out, plain, actions_exact, first), out


def phase32_routes(dev, kind, card):
    """K2a on its device-memory weight route (with K2b and K2e), chunked K2d
    and chunked K2d′ against their plain versions; returns {route: (ms, plain
    ms, error, bound)}."""
    from rware_tpu_torch.models.networks import BlockDims, GruDims
    from rware_tpu_torch.ops.fused_rollout import collect_plan

    out = {}
    # K2a at sensor range 5: both modes at 1,000 envs, then the training batch
    env_id, overrides, b, t = LONG_K2A
    for det in (True, False):
        env, build, args = long_case("mlp", env_id, overrides, LONG_COMPARE_B, 40, dev)
        collect = build(env.config, LONG_MODES_T, deterministic=det)
        plan = collect.plan
        require(plan.weights_global and not plan.kx, f"K2a {env_id}: plan {plan}")
        _, _, err, _ = route_check(f"K2a {env_id} det={det}", env, collect, args, False)
        log(f"phase 32 K2a device-memory weights {env_id} (L={env.config.policy_obs_length}) "
            f"B={LONG_COMPARE_B} T={LONG_MODES_T} deterministic={det}: obs/reward/done/state exact, two "
            f"launches bit-equal, value/logp err {err} ({tile_note(collect, LONG_COMPARE_B)}, "
            f"{plan.blocks_per_sm} blocks an SM, {plan.smem} bytes)")
    env, build, args = long_case("mlp", env_id, overrides, b, 41, dev)
    collect = build(env.config, t)
    k_ms, p_ms, err, (states, traj) = route_check(f"K2a {env_id} B={b}", env, collect, args,
                                                  False)
    n = env.n_agents
    bf, f32 = mlp_flops(env.config.policy_obs_length, 128, 128, 6, b * t * n, False)
    k_bound = bound(2 * state_bytes(args[0]) + tensor_bytes(*traj.values())
                    + tensor_bytes(*args[1].parameters()), bf, f32)
    out["k2a"] = (k_ms, p_ms, err, k_bound)
    log(f"phase 32 K2a device-memory weights {env_id} B={b} T={t} random: obs/reward/done/state "
        f"exact, two launches bit-equal, {k_ms:.3f} ms/launch = {b * t / k_ms * 1e3:.4g} "
        f"env-steps/s (plain {p_ms:.1f} ms, value/logp max_abs_err {err}; bound "
        f"{k_bound[0]:.4f} ms by {k_bound[1]}) [{kind}, {card}]")
    for mode, env_id, overrides in LONG_K2A_MODES:
        for det in (True, False):
            env, build, args = long_case(mode, env_id, overrides, LONG_COMPARE_B, 42, dev)
            collect = build(env.config, LONG_MODES_T, deterministic=det)
            require(collect.plan.weights_global and not collect.plan.kx,
                    f"K2a {env_id}: plan {collect.plan}")
            k_ms, p_ms, err, _ = route_check(f"K2a {env_id} {overrides} det={det}", env, collect,
                                             args)
            log(f"phase 32 K2a device-memory weights with "
                f"{'K2b' if env.config.msg_bits else 'K2e'} {env_id} "
                f"(L={env.config.policy_obs_length}) {overrides} B={LONG_COMPARE_B} T={LONG_MODES_T} "
                f"deterministic={det}: obs/reward/done/bits/actions/state exact, two launches "
                f"bit-equal, {k_ms:.3f} ms (plain {p_ms:.1f} ms), value/logp err {err} "
                f"({tile_note(collect, LONG_COMPARE_B)})")
    # K2d, the observation tile in chunks
    for env_id, overrides, b, t in LONG_K2D:
        env, build, args = long_case("mlp_per_agent", env_id, overrides, b, 43, dev)
        collect = build(env.config, t)
        plan = collect.plan
        require(plan.kx > 0 and plan.weights_global, f"K2d {env_id}: plan {plan}")
        k_ms, p_ms, err, (states, traj) = route_check(f"K2d chunked {env_id} {overrides}", env,
                                                      collect, args)
        dims = BlockDims(env.config.policy_obs_length, 128, 128, 5, env.config.msg_bits)
        params = torch_stack_params(args[1])
        k_bound = collect_per_agent_bound(dims, args[0], traj, params, float(b * t * env.n_agents))
        key = f"k2d{env.n_agents}m{env.config.msg_bits}"
        out[key] = (k_ms, p_ms, err, k_bound)
        log(f"phase 32 K2d chunked {env_id} (L={env.config.policy_obs_length}) {overrides} B={b} "
            f"T={t} random: obs/reward/done/bits/actions/state exact, two launches bit-equal, "
            f"{k_ms:.3f} ms/launch (plain {p_ms:.1f} ms, value/logp max_abs_err {err}; chunks of "
            f"{plan.kx} features, {tile_note(collect, b)}, {plan.blocks_per_sm} blocks an SM, "
            f"{plan.smem} bytes; bound {k_bound[0]:.4f} ms by {k_bound[1]}) [{kind}, {card}]")
    # K2d′, the observation tile in chunks
    for env_id, overrides, b, t in LONG_K2DP:
        env, build, args = long_case("gru_per_agent", env_id, overrides, b, 44, dev)
        collect = build(env.config, t)
        plan = collect.plan(b)
        require(plan.kx > 0, f"K2d′ {env_id}: plan {plan}")
        k_ms, p_ms, err, (states, carry, traj) = route_check(
            f"K2d′ chunked {env_id} {overrides}", env, collect, args)
        m = env.config.msg_bits
        dims = GruDims(env.config.policy_obs_length, 128, 128, 5, m)
        n_params = sum(p.numel() for p in args[1].parameters())
        k_bound = gru_collect_bound(dims, args[0], traj, args[3], n_params,
                                    float(b * t * env.n_agents))
        out[f"k2dp{m}"] = (k_ms, p_ms, err, k_bound)
        log(f"phase 32 K2d′ chunked {env_id} (L={env.config.policy_obs_length}) {overrides} "
            f"B={b} T={t} random: obs/reward/done/bits/actions/state/carry exact, two launches "
            f"bit-equal, {k_ms:.3f} ms/launch (plain {p_ms:.1f} ms, value/logp max_abs_err {err}; "
            f"chunks of {plan.kx} features, ring of {plan.kc} rows, {tile_note(collect, b)}, "
            f"{plan.blocks_per_sm} blocks an SM, {plan.smem} bytes; bound {k_bound[0]:.4f} ms by "
            f"{k_bound[1]}) [{kind}, {card}]")
    for mode, env_id, chunk, b, t in LONG_IMAGE:
        env, build, args = long_case(mode, env_id, {}, b, 45, dev)
        collect = build(env.config, t)
        if mode.startswith("gru"):
            plan = collect.plan(b)
        else:
            plan = collect.plan = collect_plan(env.config, collect.hidden, env.n_agents,
                                               chunk=chunk)
        require(plan.kx > 0, f"{mode} {env_id}: plan {plan}")
        k_ms, p_ms, err, _ = route_check(f"{K2E_NAMES[mode]} chunked with K2e {env_id}", env,
                                         collect, args)
        log(f"phase 32 {K2E_NAMES[mode]} chunked with K2e {env_id} "
            f"(L={env.config.policy_obs_length}) B={b} T={t} random: obs/reward/done/actions/"
            f"state{'/carry' if mode.startswith('gru') else ''} exact, two launches bit-equal, "
            f"{k_ms:.3f} ms (plain {p_ms:.1f} ms), value/logp err {err} (chunks of {plan.kx} "
            f"features{', forced' if chunk else ''})")
    return out


def torch_stack_params(policies):
    """The (N, P) float32 stack of per-agent networks' parameters (what
    ``collect_per_agent_bound`` counts)."""
    import torch

    return torch.stack([torch.cat([p.detach().reshape(-1) for p in net.parameters()])
                        for net in policies])


def phase32_learners(dev, kind, card, n_envs=16384, rollout_len=128):
    """MAPPO (3 updates) and IPPO (1) at sensor range 5, SEAC-PPO at 17
    agents and recurrent SEAC-PPO at 16 (1 each), through the learners'
    entry points on ``make``'s default device; returns the collectors' launch
    counts {route: launches}, each counter zeroed just before and read just
    after its learner's updates."""
    import torch
    import rware_tpu_torch
    from rware_tpu_torch.models import ippo, mappo, seac
    from rware_tpu_torch.models.ippo_fused import build_fused_train_step

    counts = {}
    env = rware_tpu_torch.make("rware-5s-tiny-2ag-v2")  # no device named: the card
    require(env.device.type == "cuda", f"make's default device is {env.device}")
    cfg = ippo.IPPOConfig(n_envs=n_envs, rollout_len=rollout_len, epochs=4, minibatches=4)
    n_passes = cfg.epochs * cfg.minibatches
    runner, dims, cdims = mappo.init_mappo_runner(env, cfg, seed=0)
    step = mappo.build_mappo_train_step(env, dims, cdims, cfg)
    require(step.collect.plan.weights_global and not step.collect.plan.kx,
            f"MAPPO's collector plan {step.collect.plan}")
    counted = {"fused_collect": step.collect, "fused_critic_values": step.critic_values,
               "fused_mappo_grads": step.grads}
    runner, _ = _time_learner("MAPPO", step, runner, counted,
                              {"fused_collect": 3, "fused_critic_values": 3,
                               "fused_mappo_grads": 3 * n_passes}, kind, card, cfg, phase=32,
                              need_reward=False)
    counts["k2a"] = step.collect.launches
    collect_ms, (states, traj) = cuda_ms(lambda: step.rollout(runner))
    k6_ms, values = cuda_ms(lambda: step.values(runner, traj))
    gae_ms, (obs, adv, targets) = cuda_ms(lambda: step.advantages(runner, states, traj, values))
    dataset = (traj["obs"], traj["action"], traj["logp"], values, adv, targets)
    passes_ms, _ = cuda_ms(lambda: step.update(runner, dataset))
    log(f"phase 32 MAPPO breakdown of one update at sensor range 5 (L=855): collect (K2a, "
        f"device-memory weights) {collect_ms:.3f} ms, critic values (K6) {k6_ms:.3f} ms, GAE and "
        f"bootstrap {gae_ms:.3f} ms, update phase (K5 + optimizer, {n_passes} passes) "
        f"{passes_ms:.3f} ms [{kind}, {card}]")
    del step, runner, states, traj, values, obs, adv, targets, dataset
    torch.cuda.empty_cache()

    runner, dims = ippo.init_runner(env, cfg, seed=0)
    step = build_fused_train_step(env, dims, cfg)
    step.collect.launches = step.update_phase.launches = 0
    update_ms, (runner, metrics) = cuda_ms(lambda: step(runner))
    got = {"fused_collect": step.collect.launches,
           "fused_ppo_update_phase": step.update_phase.launches}
    require(got == {"fused_collect": 1, "fused_ppo_update_phase": 1},
            f"one IPPO update launched {got}")
    require(all(bool(torch.isfinite(v.float())) for v in metrics.values()),
            f"IPPO metrics {metrics}")
    counts["k2a"] += got["fused_collect"]
    collect_ms, (states, traj) = cuda_ms(lambda: step.rollout(runner))
    gae_ms, (obs, adv, targets) = cuda_ms(lambda: step.advantages(runner, states, traj))
    dataset = (traj["obs"], traj["action"], traj["logp"], traj["value"], adv, targets)
    phase_ms, _ = cuda_ms(lambda: step.update(runner, dataset))
    log(f"phase 32 IPPO train step rware-5s-tiny-2ag-v2 B={cfg.n_envs} T={cfg.rollout_len} E=4 "
        f"M=4: {update_ms:.3f} ms for one update (the first: with its warm-up), launches {got}; "
        f"an update's phases: collect (K2a) {collect_ms:.3f} ms, GAE and last value "
        f"{gae_ms:.3f} ms, update phase (K3) {phase_ms:.3f} ms [{kind}, {card}]")
    del step, runner, states, traj, obs, adv, targets, dataset
    torch.cuda.empty_cache()

    env = rware_tpu_torch.make("rware-5s-tiny-17ag-v2")
    scfg = seac.SEACPPOConfig(n_envs=LONG_SEAC_B, rollout_len=rollout_len, epochs=4,
                              minibatches=4)
    runner, sdims = seac.init_seac_ppo(env, scfg, seed=0)
    step = seac.build_seac_ppo_fused_train_step(env, sdims, scfg)
    require(step.collect.plan.kx > 0, f"SEAC-PPO's collector plan {step.collect.plan}")
    step.collect.launches = step.grads.launches = 0
    update_ms, (runner, metrics) = cuda_ms(lambda: step(runner))
    got = {"fused_collect_per_agent": step.collect.launches,
           "fused_seac_grads": step.grads.launches}
    require(got == {"fused_collect_per_agent": 1, "fused_seac_grads": n_passes},
            f"one SEAC-PPO update launched {got}")
    require(all(bool(torch.isfinite(v.float())) for v in metrics.values()),
            f"SEAC-PPO metrics {metrics}")
    counts["k2d"] = got["fused_collect_per_agent"]
    log(f"phase 32 SEAC-PPO train step rware-5s-tiny-17ag-v2 B={scfg.n_envs} T={rollout_len} "
        f"E=4 M=4: "
        f"{update_ms:.3f} ms for one update (the first), launches {got} (K2d chunks of "
        f"{step.collect.plan.kx} features) [{kind}, {card}]")
    del step, runner
    torch.cuda.empty_cache()

    env = rware_tpu_torch.make("rware-5s-tiny-16ag-v2")
    gcfg = seac.SEACPPOConfig(n_envs=LONG_SEAC_GRU_B, rollout_len=rollout_len, epochs=4,
                              minibatches=4)
    runner, gdims = seac.init_seac_gru(env, gcfg, seed=0)
    step = seac.build_seac_gru_train_step(env, gdims, gcfg)
    plan = step.collect.plan(gcfg.n_envs)
    require(plan.kx > 0, f"recurrent SEAC-PPO's collector plan {plan}")
    step.collect.launches = 0
    update_ms, (runner, metrics) = cuda_ms(lambda: step(runner))
    got = {"fused_collect_gru_per_agent": step.collect.launches}
    require(got == {"fused_collect_gru_per_agent": 1}, f"one recurrent SEAC-PPO update: {got}")
    require(all(bool(torch.isfinite(v.float())) for v in metrics.values()),
            f"recurrent SEAC-PPO metrics {metrics}")
    counts["k2dp"] = got["fused_collect_gru_per_agent"]
    log(f"phase 32 recurrent SEAC-PPO train step rware-5s-tiny-16ag-v2 B={gcfg.n_envs} "
        f"T={rollout_len} E=4 M=4: {update_ms:.3f} ms for one update (the first), launches "
        f"{got} (K2d′ chunks of {plan.kx} features) [{kind}, {card}]")
    del step, runner
    torch.cuda.empty_cache()
    return counts


def phase32(dev, kind, card):
    """The long-observation ids on the collectors' new routes; returns their
    kernel entries."""
    start = time.perf_counter()
    routes = phase32_routes(dev, kind, card)
    counts = phase32_learners(dev, kind, card)
    log(f"phase 32 took {time.perf_counter() - start:.1f} s [{kind}, {card}]")
    replaces = "rware_tpu/ops/pallas_rollout.py:1798"
    entries = []
    for name, source, key, count in (
            ("fused_collect (device-memory weights, sensor range 5)", "collect_mlp.cuh", "k2a",
             "k2a"),
            ("fused_collect_per_agent (chunked observation tile, 17 agents)",
             "fused_collect_chunked.cu", "k2d17m0", "k2d"),
            ("fused_collect_gru_per_agent (chunked observation tile, 16 agents)",
             "fused_collect_gru_chunked.cu", "k2dp0", "k2dp")):
        k_ms, p_ms, err, k_bound = routes[key]
        entries.append(kernel_entry(name, source, replaces, counts[count], err, k_ms, p_ms,
                                    k_bound))
    return entries


# Phase 33: the learners of JAX's collect_mode="xla" (``train --collect plain``
# for MAPPO and recurrent SEAC-PPO): torch ops only, no kernel.  (learner, envs):
# MAPPO at its training batch, recurrent SEAC-PPO at JAX's (BASELINE.md:224-231).
PLAIN_LEARNERS = (("mappo", 16384), ("seac_gru", 4096))
PLAIN_CPU_ENVS = {"mappo": 512, "seac_gru": 128}  # the first envs of the card-vs-CPU update
PLAIN_LOSS_RTOL = A2C_LOSS_RTOL  # phase 30's bounds: loss terms, relative
# pg_loss and approx_kl are means of order-one terms (normalised advantages,
# ratios) that cancel to about 1e-3; a bf16 rounding that flips between the
# card's and the CPU's products moves them by about 1e-6 (1.3e-6 in recurrent
# SEAC's one pass), so each term is also given 1e-5 of its terms' scale
PLAIN_LOSS_ATOL = 1e-5
PLAIN_PARAM_LR_FRAC = A2C_PARAM_LR_FRAC  # of lr: every parameter after one step
PLAIN_SIGMAS = 5.0
PLAIN_WARM_T = 8  # steps of the warm-up update: every op of the update once, at a 16th the cost
PLAIN_OFFSET_SHARE = 0.99  # of the envs: a shard's plain collect = the global rows
PLAIN_OFFSET_LOGP = 1e-5


def kernel_wrappers() -> list:
    """Every live kernel wrapper of the port: an object of a
    ``rware_tpu_torch.ops`` class with a launch counter."""
    import gc

    out = []
    for o in gc.get_objects():
        module = getattr(type(o), "__module__", None)  # not a str on some extension types
        if isinstance(module, str) and module.startswith("rware_tpu_torch.ops.") \
                and isinstance(getattr(o, "launches", None), int):
            out.append(o)
    return out


@contextlib.contextmanager
def library_calls():
    """``{entry point: calls}`` of every call into the kernel library's
    launch entry points (``_build._SIGNATURES``) made inside the context."""
    from rware_tpu_torch.ops._build import _SIGNATURES, load_library

    lib, calls = load_library(), {}
    originals = {n: getattr(lib, n) for n in _SIGNATURES}
    for n, fn in originals.items():
        def counted(*args, _n=n, _fn=fn):
            calls[_n] = calls.get(_n, 0) + 1
            return _fn(*args)

        setattr(lib, n, counted)
    try:
        yield calls
    finally:
        for n, fn in originals.items():
            setattr(lib, n, fn)


def _frequency_gap(a, b, what):
    """|freq(a) - freq(b)| of two 0/1 tensors of one shape over the
    binomial deviation of their difference; fails past PLAIN_SIGMAS."""
    n = a.numel()
    fa, fb = float(a.double().mean()), float(b.double().mean())
    p = (fa + fb) / 2
    sigma = (p * (1 - p) * 2 / n) ** 0.5
    require(abs(fa - fb) <= PLAIN_SIGMAS * sigma + 1e-12,
            f"{what}: frequency {fa:.6g} against the fused collector's {fb:.6g} "
            f"({abs(fa - fb) / max(sigma, 1e-30):.2f} sigma)")
    return abs(fa - fb) / sigma if sigma > 0 else 0.0


def _timed_phases(step, names, n_updates, runner):
    """``n_updates`` updates of ``step`` with CUDA events around each of its
    phase methods ``names``; returns (runner, ms per update, {name: ms per
    update}, the last update's metrics and phase outputs)."""
    import torch

    events, outputs, originals = {n: [] for n in names}, {}, {}
    for name in names:
        originals[name] = getattr(step, name)

        def timed(*args, _name=name, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = originals[_name](*args, **kw)
            end.record()
            events[_name].append((start, end))
            outputs[_name] = out
            return out

        setattr(step, name, timed)
    try:
        metrics = None

        def updates():
            nonlocal runner, metrics
            for _ in range(n_updates):
                runner, metrics = step(runner)

        total_ms, _ = cuda_ms(updates)
    finally:
        for name in names:
            delattr(step, name)
    split = {n: sum(s.elapsed_time(e) for s, e in ev) / n_updates for n, ev in events.items()}
    return runner, total_ms / n_updates, split, metrics, outputs


def _plain_case(name, m, dev, n_envs, rollout_len, **passes):
    """(env, cfg, runner, step, dims) of one plain learner on ``dev``;
    ``passes`` overrides the config's epochs and minibatches."""
    import rware_tpu_torch
    from rware_tpu_torch.models import ippo, mappo, seac

    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device=dev, **({"msg_bits": m} if m else {}))
    if name == "mappo":
        cfg = ippo.IPPOConfig(n_envs=n_envs, rollout_len=rollout_len, **passes)
        runner, dims, cdims = mappo.init_mappo_runner(env, cfg, seed=33)
        step = mappo.build_mappo_train_step(env, dims, cdims, cfg, collect="plain")
    else:
        cfg = seac.SEACPPOConfig(n_envs=n_envs, rollout_len=rollout_len, **passes)
        runner, dims = seac.init_seac_gru(env, cfg, seed=33)
        step = seac.build_seac_gru_train_step(env, dims, cfg, collect="plain")
    return env, cfg, runner, step, dims


def _plain_vs_fused(name, env, cfg, runner, dims, ours):
    """The plain collect's sampling law (``ours``, the trajectory of
    ``step.rollout(runner)``) against the fused collector's (K2a for MAPPO's
    actor, K2d′ for recurrent SEAC) from the same parameters, states and
    carry, another Philox seed: each move's and bit's frequency and the share
    of env-steps with a reward; returns the largest gap in sigmas and the two
    reward shares."""
    from rware_tpu_torch.models import seac
    from rware_tpu_torch.models.ippo import policy_of
    from rware_tpu_torch.ops.fused_rollout import (
        build_fused_collect,
        build_fused_collect_gru_per_agent,
    )

    if name == "mappo":
        fused = build_fused_collect(env.config, cfg.rollout_len, (dims.h1, dims.h2))
        actor = runner.params["actor"]
        _, theirs = fused(runner.env_states, policy_of(dims, actor), 331)
    else:
        fused = build_fused_collect_gru_per_agent(env.config, cfg.rollout_len,
                                                  (dims.embed, dims.hidden))
        _, _, theirs = fused(runner.env_states, seac.seac_gru_policies_of(dims, runner.params),
                             331, runner.carry)
    require(fused.launches == 1, f"the fused collector launched {fused.launches} times")
    gaps = [_frequency_gap(ours["action"] == a, theirs["action"] == a, f"{name} move {a}")
            for a in range(5)]
    gaps += [_frequency_gap(ours["bits"][..., k] == 1, theirs["bits"][..., k] == 1,
                            f"{name} bit {k}") for k in range(env.config.msg_bits)]
    rewarded = [t["reward"].sum(-1) > 0 for t in (ours, theirs)]
    gaps.append(_frequency_gap(*rewarded, f"{name} reward share"))
    return max(gaps), [float(r.double().mean()) for r in rewarded]


def _plain_offset_check(name, step, runner, whole):
    """The plain collect of the batch's second half at ``env_offset`` = B/2
    against ``whole``, the global collect's trajectory (``step.rollout(runner)``),
    in its rows: every integer output (obs, moves,
    bits, rewards, done) equal in at least PLAIN_OFFSET_SHARE of the envs
    (cuBLAS's products, unlike the kernels' FMA chains, depend on the batch's
    shape, so a near tie may sample otherwise) and ``logp`` within
    PLAIN_OFFSET_LOGP there; returns (the share, the largest logp gap)."""
    import torch
    from rware_tpu_torch.models.ippo import collect_seed

    b, seed = runner.env_states.batch_size, collect_seed(runner.seed, runner.update_idx)
    lo = b // 2
    half = runner.env_states.map(lambda x: x[lo:])
    if name == "mappo":
        part = step.collect(half, runner.params["actor"], seed, env_offset=lo)[-1]
    else:
        part = step.collect(half, runner.params, seed, runner.carry[lo:], env_offset=lo)[-1]
    t_len = part["done"].shape[0]
    same = torch.ones(b - lo, dtype=torch.bool, device=part["done"].device)
    for k, v in part.items():
        if k != "logp":
            same &= (v == whole[k][:, lo:]).reshape(t_len, b - lo, -1).all(-1).all(0)
    share = float(same.float().mean())
    require(share >= PLAIN_OFFSET_SHARE, f"{name}: the second half at env_offset={lo} equals "
            f"the global collect's rows in {share:.4f} of its envs")
    err = float((part["logp"] - whole["logp"][:, lo:])[:, same].abs().max())
    require(err <= PLAIN_OFFSET_LOGP, f"{name}: logp at env_offset={lo} {err} from the global "
            "collect's")
    return share, err


def _plain_card_vs_cpu(name, m, dev, cfg, runner, out):
    """One pass of the update (E = M = 1: one autograd and one optimizer
    step, as phase 30's A2C update) on the first PLAIN_CPU_ENVS envs on the
    card and on the CPU, from the same trajectory (``out``, the card's plain
    collect ``step.rollout(runner)``, handed to both) and the same window;
    returns (the largest loss-term gap over its bound, the largest parameter
    gap in lr)."""
    import dataclasses

    import torch
    from rware_tpu_torch.models.ppo import AdamState

    n = PLAIN_CPU_ENVS[name]
    rows = (lambda x: x[:, :n].contiguous())
    states = out[0].map(lambda x: x[:n].contiguous())
    traj = {k: rows(v) for k, v in out[-1].items()}
    collected = (states, out[1][:n].contiguous(), traj) if name == "seac_gru" else (states, traj)
    gen = torch.Generator().manual_seed(33)
    if name == "mappo":  # the pass's window start
        windows = torch.randint(0, cfg.rollout_len, (1,), generator=gen)
    else:  # the epoch's env offset
        windows = torch.randint(0, n, (1,), generator=gen).tolist()

    def cpu(x):
        if isinstance(x, AdamState):
            return AdamState(x.count, x.mu.cpu(), x.nu.cpu())
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(cpu(v) for v in x)
        return x.map(lambda t: t.cpu()) if hasattr(x, "map") else x.cpu()

    results = []  # the card's, then the CPU's
    for where in (dev, torch.device("cpu")):
        env, _, _, cut_step, _ = _plain_case(name, m, where, n, cfg.rollout_len, epochs=1,
                                             minibatches=1)
        on = cpu if results else (lambda x: x)
        cut_runner = dataclasses.replace(
            runner, params=on(runner.params), opt_state=on(runner.opt_state),
            env_states=on(states), obs=None,
            **({"carry": on(runner.carry[:n].contiguous())} if name == "seac_gru" else {}))
        cut_step.rollout = (lambda r, c=on(collected): c)
        new, metrics = cut_step(cut_runner, windows)
        results.append((new.params, {k: float(v) for k, v in metrics.items()}))
    (p_dev, m_dev), (p_cpu, m_cpu) = results
    rel = 0.0
    for k, c in m_cpu.items():
        a = m_dev[k]
        require(abs(a - c) <= PLAIN_LOSS_RTOL * abs(c) + PLAIN_LOSS_ATOL,
                f"{name} M={m} update: {k} card {a} CPU {c}")
        rel = max(rel, abs(a - c) / (PLAIN_LOSS_RTOL * abs(c) + PLAIN_LOSS_ATOL))
    p_dev, p_cpu = (torch.cat([v.reshape(-1) for v in p.values()]) if isinstance(p, dict)
                    else p.reshape(-1) for p in (p_dev, p_cpu))
    diff = float((p_dev.cpu() - p_cpu).abs().max())
    require(diff <= PLAIN_PARAM_LR_FRAC * cfg.lr,
            f"{name} M={m} update: a parameter {diff / cfg.lr:.4f} lr from the CPU's, more than "
            f"{PLAIN_PARAM_LR_FRAC} lr")
    return rel, diff / cfg.lr


def phase33(dev, kind, card, rollout_len=128, learners=PLAIN_LEARNERS):
    """MAPPO and recurrent SEAC-PPO on JAX's XLA collect (``collect="plain"``)
    at full width, M=0 and M=2: a warm-up (one update at T=PLAIN_WARM_T) and
    two updates split into collect,
    values + GAE and passes with every kernel launch counter at 0 across them,
    the collected states' invariants, the plain collect's sampling law against
    the fused collector's, and one update on the card against the CPU."""
    import torch

    start = time.perf_counter()
    for name, n_envs in learners:
        for m in (0, 2):
            env, cfg, runner, step, dims = _plain_case(name, m, dev, n_envs, rollout_len)
            require(env.device == dev, f"the learner's env is on {env.device}")
            require(not [k for k, v in vars(step).items() if hasattr(v, "launches")],
                    f"the plain {name} step holds a kernel wrapper")
            params0 = runner.params
            # warm-up: one update of the same learner and batch at T=PLAIN_WARM_T
            warm = _plain_case(name, m, dev, n_envs, PLAIN_WARM_T)
            warm[3](warm[2])
            del warm
            wrappers = kernel_wrappers()
            for w in wrappers:
                w.launches = 0
            names = ("rollout", "values", "advantages", "update") if name == "mappo" \
                else ("rollout", "advantages", "update")
            with library_calls() as calls:
                runner, update_ms, split, metrics, outputs = _timed_phases(step, names, 2,
                                                                           runner)
            launched = {type(w).__name__: w.launches for w in wrappers if w.launches}
            require(not launched and not calls,
                    f"the plain {name} updates launched kernels: {launched} {calls}")
            check_invariants(env, outputs["rollout"][0])
            for k, v in metrics.items():
                require(bool(torch.isfinite(v.float())), f"plain {name} metric {k} is {float(v)}")
            flat = (lambda p: torch.cat([v.reshape(-1) for v in p.values()])
                    if isinstance(p, dict) else p.reshape(-1))
            require(float((flat(runner.params) - flat(params0)).abs().max()) > 0,
                    f"the plain {name} updates left the parameters unmoved")
            values_ms = split.get("values", 0.0) + split["advantages"]
            label = f"plain {'MAPPO' if name == 'mappo' else 'recurrent SEAC-PPO'} M={m}"
            log(f"phase 33 {label} (JAX's collect_mode=xla) tiny-2ag B={n_envs} "
                f"T={rollout_len} E={cfg.epochs} M={cfg.minibatches}: {update_ms:.3f} ms/update "
                f"over 2 updates after a warm-up = {n_envs * rollout_len / update_ms * 1e3:.4g} "
                f"env-steps/s: collect {split['rollout']:.3f} ms, values + GAE "
                f"{values_ms:.3f} ms, {cfg.epochs * cfg.minibatches} passes "
                f"{split['update']:.3f} ms; {len(wrappers)} kernel counters all 0 and no call "
                f"into the kernel library; invariants hold; last metrics "
                f"{ {k: round(float(v), 5) for k, v in metrics.items()} } [{kind}, {card}]")
            checks_start = time.perf_counter()
            out = step.rollout(runner)  # the next update's plain collect, checked three ways
            check_invariants(env, out[0])
            gap, rewards = _plain_vs_fused(name, env, cfg, runner, dims, out[-1])
            share, logp_gap = _plain_offset_check(name, step, runner, out[-1])
            rel, lr_gap = _plain_card_vs_cpu(name, m, dev, cfg, runner, out)
            log(f"phase 33 {label}: sampling law against the fused collector within {gap:.2f} "
                f"sigma (reward shares {rewards[0]:.3g} / {rewards[1]:.3g}); the second half "
                f"at env_offset = B/2 equal to the global collect's rows in {share:.4f} of its "
                f"envs, logp within {logp_gap:.3g} there; one pass of the "
                f"update on {PLAIN_CPU_ENVS[name]} envs card against CPU: loss terms within "
                f"{rel:.3g} of their bound (rtol {PLAIN_LOSS_RTOL}, atol {PLAIN_LOSS_ATOL}), "
                f"every parameter within {lr_gap:.4f} lr; these checks "
                f"{time.perf_counter() - checks_start:.1f} s [{kind}, {card}]")
    log(f"phase 33 took {time.perf_counter() - start:.1f} s [{kind}, {card}]")


def timed(fn, *args):
    """``fn(*args)``, logging its seconds and the script's seconds so far."""
    start = time.perf_counter()
    out = fn(*args)
    end = time.perf_counter()
    log(f"{fn.__name__}: {end - start:.1f} s, {end - SCRIPT_START:.1f} s since the start")
    return out


def main() -> int:
    import torch

    # ---- phase 1: device --------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU")
    from rware_tpu_torch.ops._build import load_library

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
    ptxas = [l.strip().replace("ptxas info    : ", "") for l in lib.build_log.splitlines()
             if "registers" in l or "spill" in l or "Function properties" in l]
    log(f"phase 2 build: nvcc sm_90a {lib.build_seconds:.1f} s (load {time.perf_counter() - start:.1f} s); "
        + " ; ".join(ptxas))

    timed(phase3, dev)
    timed(phase4, dev)
    kernels = timed(phase5, dev, kind, card)
    timed(phase6, dev, kind, card)
    timed(phase7, dev, kind, card)
    kernels += timed(phase8, dev, kind, card)
    timed(phase9, dev, kind, card)
    timed(phase10, dev, kind, card)
    kernels += timed(phase11, dev, kind, card)
    k2c_err = timed(phase12, dev, kind, card)
    timed(phase13, dev, kind, card)
    kernels += timed(phase14, dev, kind, card, k2c_err)
    timed(phase15, dev, kind, card)
    timed(phase16, dev, kind, card)
    kernels += timed(phase17, dev, kind, card)
    k1m_entry = timed(phase18, dev, kind, card)
    timed(phase19, dev, kind, card)
    kernels += [k1m_entry] + timed(phase20, dev, kind, card)
    errs = timed(phase21, dev, kind, card)
    kernels += timed(phase22, dev, kind, card, errs)
    kernels += timed(phase23, dev, kind, card)
    timed(phase24, dev, kind, card)
    kernels += timed(phase25, dev, kind, card)
    timed(phase26, dev, kind, card)
    kernels += timed(phase27, dev, kind, card)
    timed(phase28, dev, kind, card)
    timed(phase29, dev, kind, card)
    kernels += timed(phase30, dev, kind, card)
    timed(phase31, dev, kind, card)
    kernels += timed(phase32, dev, kind, card)
    timed(phase33, dev, kind, card)
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank process of phase 31c
        from rware_tpu_torch.testing import dp_rank_main

        dp_rank_main(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    sys.exit(main())
