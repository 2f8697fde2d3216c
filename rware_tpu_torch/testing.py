"""State-injection helpers (the counterpart of ``rware_tpu/testing.py``).

:func:`make_state` builds an exact one-env state (B = 1) for a test scenario,
with shelves at their home slots unless overridden — the functional form of
the reference's "mutate agents and shelves, then ``_recalc_grid()``" test
pattern (reference tests/test_movement.py:14-61).

For data parallelism: :func:`emulate_mesh` runs the ranks of a mesh as
threads of one process (the in-process emulation the tests and
``chip_smoke.py`` hold a process group's run to), :func:`dp_learner` builds
each learner that trains under a mesh, :func:`dp_run` runs one and returns what
the checks compare, and :func:`dp_task` runs one task of a data-parallel
check on a rank.  :func:`dp_spawn` starts the rank processes of a process
group on a list of tasks (each runs :func:`dp_rank_main`) and
:func:`dp_results` collects what they wrote.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
from typing import Optional, Sequence, Tuple

import torch

from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.core.state import WarehouseState
from rware_tpu_torch.parallel.sharding import Mesh
from rware_tpu_torch.types import Direction


def make_state(
    config: WarehouseConfig,
    agents: Sequence[Tuple],
    *,
    shelves: Optional[Sequence[Tuple[int, int]]] = None,
    queue: Optional[Sequence[int]] = None,
    carrying: Optional[Sequence[int]] = None,
    has_delivered: Optional[Sequence[bool]] = None,
    agent_message: Optional[Sequence[Sequence[float]]] = None,
    device="cpu",
) -> WarehouseState:
    """Build a one-env WarehouseState for a test scenario.

    Args:
      config: static env config (must match the lengths given here).
      agents: per-agent ``(x, y, direction)`` tuples.
      shelves: optional per-shelf ``(x, y)``; defaults to home rack slots.
      queue: optional request-queue shelf indices (0-based); defaults to
        ``[0, 1, ..., R-1]``.
      carrying: optional per-agent carried shelf index or -1.
      has_delivered: optional per-agent TWO_STAGE delivery flags.
      agent_message: optional per-agent message bits (N lists of msg_bits
        values); zeros by default.
      device: where the state's tensors live.
    """
    layout = config.compile_layout()
    n = config.n_agents
    if len(agents) != n:
        raise ValueError(f"need {n} agent tuples, got {len(agents)}")

    def ints(values):
        return torch.tensor([list(values)], dtype=torch.int32, device=device)

    ax = ints(a[0] for a in agents)
    ay = ints(a[1] for a in agents)
    adir = ints(int(a[2]) for a in agents)
    if shelves is None:
        sx = ints(layout.shelf_slots[:, 0].tolist())
        sy = ints(layout.shelf_slots[:, 1].tolist())
    else:
        if len(shelves) != layout.n_shelves:
            raise ValueError(
                f"need {layout.n_shelves} shelf positions, got {len(shelves)}"
            )
        sx = ints(s[0] for s in shelves)
        sy = ints(s[1] for s in shelves)
    if queue is None:
        queue = range(config.request_queue_size)
    if carrying is None:
        carrying = [-1] * n
    if has_delivered is None:
        has_delivered = [False] * n

    # Carried shelves ride on their carrier (reference invariant).
    for i, c in enumerate(carrying):
        if c >= 0:
            sx[0, c] = ax[0, i]
            sy[0, c] = ay[0, i]

    zero = torch.zeros(1, dtype=torch.int32, device=device)
    return WarehouseState(
        agent_x=ax,
        agent_y=ay,
        agent_dir=adir,
        agent_carrying=ints(carrying),
        agent_has_delivered=torch.tensor(
            [list(has_delivered)], dtype=torch.bool, device=device
        ),
        agent_message=(
            torch.zeros((1, n, config.msg_bits), dtype=torch.float32, device=device)
            if agent_message is None
            else torch.tensor([list(map(list, agent_message))], dtype=torch.float32,
                              device=device).reshape(1, n, config.msg_bits)
        ),
        shelf_x=sx,
        shelf_y=sy,
        request_queue=ints(queue).reshape(1, -1),
        cur_steps=zero.clone(),
        cur_inactive_steps=zero.clone(),
    )


def random_ppo_case(env_id: str, n_envs: int, t_full: int, seed: int = 0, device="cpu",
                    msg_bits: int = 0, hidden: Tuple[int, int] = (128, 128)):
    """``(dims, params, data)`` of random inputs for the PPO kernels at
    ``env_id``'s observation length and agent count: flax-initialised
    parameters at ``hidden``, and a ``(T, B, N, ...)`` trajectory of
    bf16 0/1 features, actions, logp near log(1/5), and normal values,
    advantages and targets (``torch.Generator`` seeded on ``device``).  With
    ``msg_bits`` M the net has a message head, logp is near log(1/5) + M
    log(1/2) and a 7th entry holds random bits (T, B, N, M) int32."""
    import dataclasses

    from rware_tpu_torch.models.networks import (
        BlockDims,
        init_actor_critic,
        pack_arrays,
        params_to_arrays,
    )
    from rware_tpu_torch.registry import parse_env_id

    cfg = dataclasses.replace(parse_env_id(env_id), msg_bits=msg_bits)
    l_obs, shape = cfg.policy_obs_length, (t_full, n_envs, cfg.n_agents)
    model = init_actor_critic(l_obs, 5, hidden, seed, msg_bits)
    params = pack_arrays(params_to_arrays(model)).detach().to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    data = (
        (torch.rand(shape + (l_obs,), generator=gen, device=device) < 0.3).to(torch.bfloat16),
        torch.randint(0, 5, shape, generator=gen, device=device, dtype=torch.int32),
        torch.randn(shape, generator=gen, device=device) * 0.1 - 1.6 - 0.69 * msg_bits,
        *(torch.randn(shape, generator=gen, device=device) for _ in range(3)),
    )
    if msg_bits:
        data += (torch.randint(0, 2, shape + (msg_bits,), generator=gen, device=device,
                               dtype=torch.int32),)
    return BlockDims.of(model), params, data


def random_mappo_case(env_id: str, n_envs: int, t_full: int, seed: int = 0, device="cpu",
                      hidden: Tuple[int, int] = (128, 128)):
    """``(dims, cdims, params, data)``: :func:`random_ppo_case` plus a
    flax-initialised central critic, both at ``hidden``; ``params`` is the
    ``{"actor", "critic"}`` dict of flat vectors."""
    from rware_tpu_torch.models.networks import (
        CriticDims,
        critic_to_arrays,
        init_central_critic,
        pack_arrays,
    )

    dims, actor, data = random_ppo_case(env_id, n_envs, t_full, seed, device, hidden=hidden)
    n = data[1].shape[2]
    critic = init_central_critic(n * dims.obs_len, n, hidden, (seed, 1))
    params = {"actor": actor,
              "critic": pack_arrays(critic_to_arrays(critic)).detach().to(device)}
    return dims, CriticDims.of(critic), params, data


def random_seac_case(env_id: str, n_envs: int, t_full: int, seed: int = 0, device="cpu",
                     hidden: Tuple[int, int] = (128, 128)):
    """``(dims, params, data)`` of random inputs for SEAC-PPO's gradient
    kernel: the obs, actions and behaviour log-probs of
    :func:`random_ppo_case`, normal old values, advantages and targets as
    ``(N_i, T, B, N_j)`` cross arrays, and N independent flax-initialised
    networks at ``hidden`` stacked into ``(N, P)``, biases off zero."""
    from rware_tpu_torch.models.networks import init_actor_critic, pack_arrays, params_to_arrays

    dims, _, data = random_ppo_case(env_id, n_envs, t_full, seed, device, hidden=hidden)
    n = data[1].shape[2]
    params = torch.stack([
        pack_arrays(params_to_arrays(init_actor_critic(dims.obs_len, 5, hidden, (seed, 2, i))))
        for i in range(n)]).detach().to(device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for row in params:
        for block in dims.split(row):
            if block.shape[0] == 1:  # a bias
                block += 0.1 * torch.randn(block.shape, generator=gen, device=device)
    cross = tuple(torch.randn((n,) + tuple(data[1].shape), generator=gen, device=device)
                  for _ in range(3))
    return dims, params, data[:3] + cross


UP = Direction.UP
DOWN = Direction.DOWN
LEFT = Direction.LEFT
RIGHT = Direction.RIGHT


def random_gru_seq_case(env_id: str, n_envs: int, t_len: int, band: Tuple[int, int],
                        seed: int = 0, device="cpu", hidden: int = 128, embed: int = 128):
    """``(dims, args)`` of random inputs for the iall-fed GRU kernels (K11,
    K12, K13) on the env band ``band`` = (start_env, n_env) of a batch of
    ``n_envs`` at ``env_id``'s observation length and agent count: a
    flax-initialised recurrent actor with its biases moved off zero; ``iall``
    (T, n_env, N, 3Hg) bf16, the fused input gates of 0/0.5/1 observations
    (:func:`~rware_tpu_torch.models.networks.gru_embed_gates`); ``done`` (T,
    B) at 20%; a nonzero carry ``h0`` (B, N, Hg) bf16; the loss streams of
    :func:`random_ppo_case` (T, B, N) and the band's advantage ``stats``.
    ``args`` is a dict keyed by the kernels' argument names (``wh``, ``bhn``,
    ``whead``, ``bhead``, ``iall``, ``done``, ``h0``, ``action``, ``logp``,
    ``value``, ``adv``, ``target``, ``stats``)."""
    from rware_tpu_torch.models.networks import (
        GruDims,
        gru_embed_gates,
        gru_to_arrays,
        init_recurrent_actor_critic,
    )
    from rware_tpu_torch.ops.fused_gru import band_index
    from rware_tpu_torch.registry import parse_env_id

    cfg = parse_env_id(env_id)
    l_obs, n = cfg.policy_obs_length, cfg.n_agents
    model = init_recurrent_actor_critic(l_obs, 5, hidden, embed, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    arrays = [a.detach().to(device) for a in gru_to_arrays(model)]
    arrays = [a + 0.1 * torch.randn(a.shape, generator=gen, device=device) if a.shape[0] == 1
              else a for a in arrays]
    we, be, wi, bi, wh, bhn, wc, bc = arrays
    start, n_env = band
    obs = torch.randint(0, 3, (t_len, n_env, n, l_obs), generator=gen, device=device) * 0.5
    with torch.no_grad():
        iall = gru_embed_gates((we, be, wi, bi), obs)[1].to(torch.bfloat16)
    shape = (t_len, n_envs, n)
    adv = torch.randn(shape, generator=gen, device=device)
    advb = adv[:, band_index(start, n_env, n_envs, device)]
    args = dict(
        wh=wh, bhn=bhn, whead=wc, bhead=bc[0], iall=iall,
        done=torch.rand((t_len, n_envs), generator=gen, device=device) < 0.2,
        h0=(torch.rand((n_envs, n, hidden), generator=gen, device=device) * 2 - 1
            ).to(torch.bfloat16),
        action=torch.randint(0, 5, shape, generator=gen, device=device, dtype=torch.int32),
        logp=torch.randn(shape, generator=gen, device=device) * 0.1 - 1.6,
        value=torch.randn(shape, generator=gen, device=device), adv=adv,
        target=torch.randn(shape, generator=gen, device=device),
        stats=torch.stack([advb.mean(), 1.0 / (advb.std(correction=0) + 1e-8)]),
    )
    return GruDims.of(model), args


def positions(state: WarehouseState, env: int = 0) -> list:
    """[(x, y), ...] per agent of one env — concise assertion helper."""
    return list(zip(state.agent_x[env].tolist(), state.agent_y[env].tolist()))


# ---------------------------------------------------------------------------
# Data parallelism in one process: the learners of a mesh, rank by rank
# ---------------------------------------------------------------------------

# the learners JAX builds with mesh= (per-shard statistics: its five, MAPPO and
# recurrent SEAC-PPO also on the plain collect of its collect_mode="xla"), then
# the five it only places on a mesh (whole-batch statistics)
DP_LEARNERS = ("ippo", "rnn_ippo", "rnn_ippo_fused_loss", "mappo", "rnn_mappo", "seac_gru",
               "mappo_plain", "seac_gru_plain",
               "ippo_plain", "rnn_ippo_plain", "seac", "seac_flat", "seac_a2c")
DP_PLACED = DP_LEARNERS[8:]


class _ThreadGroup:
    """The collectives of ``world`` threads of one process: each deposits its
    tensor, and every one combines the deposits (a sum in rank order: two
    ranks' sum is the same in either order, as gloo's and NCCL's)."""

    def __init__(self, world: int, timeout: float):
        import threading

        self.barrier = threading.Barrier(world, timeout=timeout)
        self.slots = [None] * world

    def exchange(self, rank: int, buf: torch.Tensor, combine) -> None:
        self.slots[rank] = buf.clone()
        self.barrier.wait()
        out = combine(self.slots)
        self.barrier.wait()  # every rank has read the deposits before the next exchange
        buf.copy_(out)


class ThreadMesh(Mesh):
    """A :class:`~rware_tpu_torch.parallel.sharding.Mesh` whose collectives
    run between the threads of :func:`emulate_mesh` (``group`` a
    ``_ThreadGroup``)."""

    def _run(self, kind, buf, **kw):
        self.counts[kind] += 1
        if kind == "all_reduce":
            def combine(slots):
                out = slots[0].clone()
                for other in slots[1:]:
                    out += other
                return out
        else:
            def combine(slots):
                return slots[kw.get("src", 0)]
        self.group.exchange(self.rank, buf, combine)


def emulate_mesh(fn, world: int, device="cpu", timeout: float = 600.0) -> list:
    """``[fn(mesh_r) for r in range(world)]``, the ranks run as threads of
    this process whose collectives (the same packing, a sum in rank order)
    stand in for a process group's: the in-process emulation of a
    data-parallel run.  A rank that waits ``timeout`` seconds for the others
    raises ``threading.BrokenBarrierError``."""
    import threading

    group = _ThreadGroup(world, timeout)
    out, errors = [None] * world, []

    def run(rank):
        try:
            out[rank] = fn(ThreadMesh(group, rank, world, torch.device(device)))
        except Exception as exc:  # re-raised in the caller's thread below
            errors.append(exc)
            group.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def dp_learner(name: str, env, cfg, seed: int, mesh=None, deterministic: bool = False,
               hidden: int = 128):
    """(runner, train step) of one of :data:`DP_LEARNERS` built with
    ``mesh`` (this rank's envs of ``cfg.n_envs``; None: all of them) at
    hidden width ``hidden``; IPPO and MAPPO take their per-pass kernels (K4,
    K5); ``mappo_plain`` and ``seac_gru_plain`` are MAPPO and recurrent
    SEAC-PPO on JAX's XLA collect (``collect="plain"``, which has no
    deterministic mode); ``ippo_plain`` and ``rnn_ippo_plain`` are the plain learners,
    ``seac`` SEAC-PPO on K8, ``seac_flat`` its flat learner, ``seac_a2c``
    SEAC A2C.  ``cfg`` is the learner's config (:func:`dp_config`)."""
    from rware_tpu_torch.models import ippo, ippo_fused, ippo_rnn, mappo, seac

    h2 = (hidden, hidden)
    if name == "ippo":
        runner, dims = ippo.init_runner(env, cfg, seed, h2, mesh=mesh)
        step = ippo_fused.build_fused_train_step(env, dims, cfg, deterministic,
                                                 fused_update_phase=False, mesh=mesh)
    elif name in ("rnn_ippo", "rnn_ippo_fused_loss"):
        runner, dims = ippo_rnn.init_rnn_runner(env, cfg, seed, hidden, hidden, mesh=mesh)
        step = ippo_rnn.build_rnn_fused_train_step(env, dims, cfg, deterministic,
                                                   fused_loss=name.endswith("fused_loss"),
                                                   mesh=mesh)
    elif name == "mappo":
        runner, dims, cdims = mappo.init_mappo_runner(env, cfg, seed, h2, h2, mesh=mesh)
        step = mappo.build_mappo_train_step(env, dims, cdims, cfg, deterministic, mesh=mesh)
    elif name == "rnn_mappo":
        runner, dims, cdims = mappo.init_rnn_mappo_runner(env, cfg, seed, hidden, hidden, h2,
                                                          mesh=mesh)
        step = mappo.build_rnn_mappo_train_step(env, dims, cdims, cfg, deterministic,
                                                mesh=mesh)
    elif name == "mappo_plain":
        runner, dims, cdims = mappo.init_mappo_runner(env, cfg, seed, h2, h2, mesh=mesh)
        step = mappo.build_mappo_train_step(env, dims, cdims, cfg, mesh=mesh, collect="plain")
    elif name in ("seac_gru", "seac_gru_plain"):
        runner, dims = seac.init_seac_gru(env, cfg, seed, hidden, hidden, mesh=mesh)
        plain = name.endswith("plain")
        step = seac.build_seac_gru_train_step(env, dims, cfg, deterministic and not plain,
                                              mesh=mesh, collect="plain" if plain else "fused")
    elif name == "ippo_plain":
        runner, dims = ippo.init_runner(env, cfg, seed, h2, mesh=mesh)
        step = ippo.build_train_step(env, dims, cfg, mesh=mesh)
    elif name == "rnn_ippo_plain":
        runner, dims = ippo_rnn.init_rnn_runner(env, cfg, seed, hidden, hidden, mesh=mesh)
        step = ippo_rnn.build_rnn_train_step(env, dims, cfg, mesh=mesh)
    elif name == "seac":
        runner, dims = seac.init_seac_ppo(env, cfg, seed, h2, mesh=mesh)
        step = seac.build_seac_ppo_fused_train_step(env, dims, cfg, deterministic, mesh=mesh)
    elif name == "seac_flat":
        runner, dims = seac.init_seac_ppo(env, cfg, seed, h2, mesh=mesh)
        step = seac.build_seac_ppo_train_step(env, dims, cfg, deterministic_collect=deterministic,
                                              mesh=mesh)
    elif name == "seac_a2c":
        runner, dims = seac.init_seac(env, cfg, seed, h2, mesh=mesh)
        step = seac.build_seac_train_step(env, dims, cfg, mesh=mesh)
    else:
        raise ValueError(f"unknown learner {name!r}; one of {DP_LEARNERS}")
    return runner, step


def dp_config(name: str, **fields):
    """The config of learner ``name`` of :data:`DP_LEARNERS` from
    ``fields`` (an ``IPPOConfig``'s; SEAC A2C takes the batch and rollout
    of them, SEAC-PPO all it has)."""
    from rware_tpu_torch.models.ippo import IPPOConfig
    from rware_tpu_torch.models.seac import SEACConfig, SEACPPOConfig

    kind = {"seac_gru": SEACPPOConfig, "seac_gru_plain": SEACPPOConfig, "seac": SEACPPOConfig,
            "seac_flat": SEACPPOConfig, "seac_a2c": SEACConfig}.get(name, IPPOConfig)
    names = {f.name for f in dataclasses.fields(kind)}
    return kind(**{k: v for k, v in fields.items() if k in names})


def dp_run(step, runner, n_updates: int, mesh=None, windows=None) -> dict:
    """Run ``n_updates`` updates of ``step`` from ``runner`` (``windows[u]``
    the u-th update's window starts, epoch offsets or permutations, else
    drawn from the runner's generator) and return what a data-parallel
    check compares: the first update's trajectory, the collectives of its
    collect alone and of each update (with a mesh, zeroed first), each
    update's metrics, the launches of the step's kernel wrappers over the
    updates (by attribute name), and the final runner."""
    if mesh is not None:
        mesh.reset_counts()
    traj = step.rollout(runner)[-1]
    collect_counts = dict(mesh.counts) if mesh is not None else {}
    wrappers = {k: v for k, v in vars(step).items() if hasattr(v, "launches")}
    before = {k: v.launches for k, v in wrappers.items()}
    per_update, metrics = [], []
    for u in range(n_updates):
        if mesh is not None:
            mesh.reset_counts()
        if windows is None:
            runner, m = step(runner)
        else:
            runner, m = step(runner, torch.as_tensor(windows[u]))
        per_update.append(dict(mesh.counts) if mesh is not None else {})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"traj": traj, "collect_counts": collect_counts, "update_counts": per_update,
            "metrics": metrics, "runner": runner,
            "launches": {k: v.launches - before[k] for k, v in wrappers.items()}}


def digest(tree) -> str:
    """sha256 of every tensor of ``tree`` (dicts in key order), its bytes as
    they lie on the CPU."""
    import hashlib

    h = hashlib.sha256()

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, torch.Tensor):
            h.update(str((node.dtype, tuple(node.shape))).encode())
            h.update(node.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy()
                     .tobytes())

    walk(tree)
    return h.hexdigest()


def _task_learner(task, mesh, device):
    """(runner, step) of a task's learner on this rank, its parameters
    and optimizer state (and, with ``override``, its env states and carry:
    this rank's rows of a given global runner's) replicated from rank 0."""
    import rware_tpu_torch
    from rware_tpu_torch.models.ippo import policy_obs_fn
    from rware_tpu_torch.parallel.sharding import replicate, shard_env_batch

    env = rware_tpu_torch.make(task["env_id"], device=device, **task.get("env_overrides", {}))
    name = task.get("learner", "ippo")
    cfg = dp_config(name, **task["cfg"])
    runner, step = dp_learner(name, env, cfg, task["seed"], mesh,
                              task.get("deterministic", False), task["hidden"])
    over = task.get("override")
    if over:
        def local(x):
            return x if mesh is None else shard_env_batch(x, mesh)

        states = local(over["env_states"])
        runner = dataclasses.replace(runner, params=over["params"], opt_state=over["opt_state"],
                                     env_states=states, obs=policy_obs_fn(env)(states))
        if "carry" in over:
            runner = dataclasses.replace(runner, carry=local(over["carry"]))
    if mesh is not None:
        runner = dataclasses.replace(runner, params=replicate(runner.params, mesh),
                                     opt_state=replicate(runner.opt_state, mesh))
    return runner, step


def dp_task(task: dict, mesh: Optional[Mesh] = None, device="cpu", tmp_dir: str = "") -> dict:
    """One task of a data-parallel check on this rank (``mesh``; None: the
    whole batch in one process), on ``device``.  ``task["kind"]``:

    * ``learner``: :func:`dp_learner` of ``task["learner"]`` at ``cfg``,
      ``seed`` and ``hidden`` (``override``: the parameters, optimizer state,
      env states and carry of a given global runner), then :func:`dp_run` of
      ``n_updates`` updates (``windows``: their window starts or offsets).
      The runner comes back packed, and its parameters under ``params``;
      with ``digest`` the trajectory, the runner and its replicated part
      (parameters and optimizer state) come back as :func:`digest` strings.
    * ``checkpoint``: ``n_updates`` (default 2) updates of that learner, its
      runner saved after each by a ``Checkpointer(rank, world)`` under
      ``tmp_dir``, then restored, and a restore at world size 1 refused; a
      process group's ranks only.
    * ``aggregate``: ``profiling.aggregate_across_hosts`` of metrics that
      differ by rank.
    * ``train``: ``train.main(task["argv"])`` in this rank's process group
      (``--distributed``, which keeps the group); returns its last log entry
      and what it printed.
    """
    from rware_tpu_torch.checkpoint import Checkpointer, pack

    if task["kind"] == "learner":
        runner, step = _task_learner(task, mesh, device)
        out = dp_run(step, runner, task["n_updates"], mesh, task.get("windows"))
        out["runner"] = pack(out["runner"])
        out["params"] = out["runner"]["params"]
        if task.get("digest"):
            out["replicated"] = digest({k: out["runner"][k] for k in ("params", "opt_state")})
            out["runner"], out["traj"] = digest(out["runner"]), digest(out["traj"])
        return out
    if task["kind"] == "checkpoint":
        import torch.distributed as dist

        runner, step = _task_learner(task, mesh, device)
        directory = os.path.join(tmp_dir, task["name"])
        ckpt = Checkpointer(directory, rank=mesh.rank, world=mesh.world)
        for u in range(task.get("n_updates", 2)):
            runner, _ = step(runner)
            ckpt.save(u + 1, runner)
        dist.barrier()
        restored = ckpt.restore(template=runner)
        files = sorted(os.listdir(directory))
        refused = ""
        try:
            Checkpointer(directory).restore(template=runner)
        except ValueError as exc:
            refused = str(exc)
        dist.barrier()
        saved, restored = pack(runner), pack(restored)
        if task.get("digest"):
            saved, restored = digest(saved), digest(restored)
        return {"steps": ckpt.steps(), "files": files, "refused": refused, "saved": saved,
                "restored": restored}
    if task["kind"] == "train":
        import contextlib
        import io

        from rware_tpu_torch import train

        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            entry = train.main(task["argv"])
        return {"entry": entry, "printed": printed.getvalue()}
    if task["kind"] == "aggregate":
        from rware_tpu_torch.profiling import aggregate_across_hosts

        metrics = {"rank": float(mesh.rank), "same": 2.5}
        return {"mean": aggregate_across_hosts(metrics),
                "sum": aggregate_across_hosts(metrics, reduce="sum")}
    raise ValueError(f"unknown task kind {task['kind']!r}")


def dp_rank_main(spec: str, rank: int) -> None:
    """A rank process of :func:`dp_spawn`: joins the spec's gloo process
    group (through the file store ``store``, ``world`` ranks) as
    ``rank``, runs every task on the spec's ``device`` and writes each
    task's result to ``<out>/<task name>.rank<rank>.pt``.  On a CUDA device
    it loads the kernels' library built by the parent and refuses to build
    it."""
    from rware_tpu_torch.distributed import initialize
    from rware_tpu_torch.parallel.sharding import make_mesh

    job = torch.load(spec, weights_only=False)
    if job.get("threads"):
        torch.set_num_threads(job["threads"])
    device = torch.device(job["device"])
    if device.type == "cuda":
        from rware_tpu_torch.ops._build import load_library

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if load_library().build_seconds:
            raise RuntimeError("a rank process built the kernels: the parent builds them first")
    world = job["world"]
    if initialize(f"file://{job['store']}", world, rank, device=device,
                  backend="gloo") != (rank, world):
        raise RuntimeError(f"rank {rank} of {world} did not join its process group")
    mesh = make_mesh(device=device)
    for task in job["tasks"]:
        result = dp_task(task, mesh, device, os.path.dirname(job["out"]))
        torch.save(result, os.path.join(job["out"], f"{task['name']}.rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


def dp_spawn(entry: Sequence[str], tasks: list, world: int, tmp_dir: str, device="cpu",
             threads: Optional[int] = None) -> list:
    """Start ``world`` rank processes, ``[*entry, SPEC, RANK]`` (a program
    that calls :func:`dp_rank_main` with them), on ``tasks`` in a gloo
    process group on ``device`` (NCCL needs a GPU a rank), with ``threads``
    CPU threads each (None: torch's default), their files under
    ``tmp_dir``; returns their ``Popen``."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = os.path.join(tmp_dir, "spec.pt")
    out = os.path.join(tmp_dir, "out")
    os.makedirs(out, exist_ok=True)
    torch.save({"tasks": tasks, "world": world, "device": str(device),
                "store": os.path.join(tmp_dir, "store"), "out": out, "threads": threads},
               spec)
    env = dict(os.environ, PYTHONPATH=repo)
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    return [subprocess.Popen([*entry, spec, str(r)], cwd=repo, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def dp_results(procs: list, tasks: list, tmp_dir: str, timeout: float = 900) -> dict:
    """{task name: [rank 0's result, rank 1's, ...]} once every rank of
    :func:`dp_spawn` exits; kills the ranks and raises with a rank's output
    if one failed or ran past ``timeout`` seconds."""
    try:
        for rank, proc in enumerate(procs):
            text = proc.communicate(timeout=timeout)[0]
            if proc.returncode != 0:
                raise RuntimeError(f"rank {rank} exited with {proc.returncode}:\n{text[-4000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = os.path.join(tmp_dir, "out")
    return {t["name"]: [torch.load(os.path.join(out, f"{t['name']}.rank{r}.pt"),
                                   weights_only=False) for r in range(len(procs))]
            for t in tasks}
