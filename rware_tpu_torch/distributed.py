"""Multi-process scale-out and recovery (the counterpart of
``rware_tpu/distributed.py``).

One process a device under ``torch.distributed``: :func:`initialize` joins
the process group, :func:`~rware_tpu_torch.parallel.sharding.make_mesh`
gives the rank's view of it, and each rank builds only its own rows of the
global env batch (:func:`global_env_batch`).  The learners built with the
mesh all-reduce their gradients once a minibatch pass
(:mod:`rware_tpu_torch.parallel.sharding`).

Recovery is a deterministic restart, as in the JAX package: the whole
training state is one runner (:mod:`rware_tpu_torch.checkpoint`) and an
update is a function of it, so after a failure every rank restores the
latest complete checkpoint and replays (:func:`run_with_recovery`).
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Optional, Tuple

import torch

from rware_tpu_torch.parallel.sharding import Mesh

_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
) -> Tuple[int, int]:
    """Join the ``torch.distributed`` process group; returns (rank, world
    size).

    Explicit arguments win; otherwise ``RWARE_COORD_ADDR`` (``host:port``) /
    ``RWARE_NUM_PROCS`` / ``RWARE_PROC_ID`` configure the group, as for the
    JAX package, and without them the environment that
    ``torch.distributed.run`` (torchrun) sets (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``).  With neither, and no coordinator
    and at most one process asked for, it is a no-op returning ``(0, 1)``.
    The backend is ``backend`` if given, else NCCL for a CUDA ``device`` and
    gloo for the CPU (``device`` None).  A group already initialised is
    kept."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None:
        coordinator_address = os.environ.get("RWARE_COORD_ADDR")
        if num_processes is None and "RWARE_NUM_PROCS" in os.environ:
            num_processes = int(os.environ["RWARE_NUM_PROCS"])
        if process_id is None and "RWARE_PROC_ID" in os.environ:
            process_id = int(os.environ["RWARE_PROC_ID"])
    if backend is None:
        backend = "nccl" if device is not None and torch.device(device).type == "cuda" \
            else "gloo"
    if coordinator_address or (num_processes is not None and num_processes > 1):
        if not coordinator_address:
            raise ValueError("a process group of several processes needs a coordinator "
                             "address (host:port, or RWARE_COORD_ADDR)")
        if num_processes is None or process_id is None:
            raise ValueError("give the number of processes and this process's id "
                             "(or RWARE_NUM_PROCS and RWARE_PROC_ID)")
        address = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=address, world_size=num_processes,
                                rank=process_id)
    elif all(k in os.environ for k in _TORCHRUN):
        dist.init_process_group(backend, init_method="env://")
    else:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_env_batch(make_local: Callable[[int, int], Any], n_envs: int,
                     mesh: Optional[Mesh] = None) -> Any:
    """This rank's piece of a global env batch: ``make_local(start, count)``
    builds the rows ``[start, start + count)`` this rank owns (a reset keyed
    by the global env index, ``batched_reset(env, seed, count, start)``).
    Without a mesh, the whole batch; refuses ``n_envs`` that the world size
    does not divide."""
    if mesh is None:
        return make_local(0, n_envs)
    return make_local(mesh.env_offset(n_envs), mesh.n_local(n_envs))


def run_with_recovery(
    train_step: Callable[[Any], Tuple[Any, dict]],
    runner: Any,
    n_updates: int,
    checkpointer=None,
    checkpoint_every: int = 50,
    max_restarts: int = 3,
    on_metrics: Optional[Callable[[int, dict], None]] = None,
) -> Any:
    """Training loop with checkpoint-based failure recovery.

    On a ``RuntimeError`` (torch's CUDA and distributed errors are ones) the
    loop restores the latest complete checkpoint of ``checkpointer`` (a
    :class:`~rware_tpu_torch.checkpoint.Checkpointer`) and resumes: the
    deterministic-restart model.  Raises after ``max_restarts`` failures, or
    at the first one without a checkpointer."""
    restarts = 0
    u = int(runner.update_idx)
    if checkpointer is not None and checkpointer.latest_step is None:
        # an anchor, so that a failure before the first periodic save recovers
        checkpointer.save(u, runner)
    while u < n_updates:
        try:
            runner, metrics = train_step(runner)
            u += 1
            if on_metrics is not None:
                on_metrics(u, metrics)
            if checkpointer is not None and u % checkpoint_every == 0:
                checkpointer.save(u, runner)
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts or checkpointer is None:
                raise
            time.sleep(1.0)
            runner = checkpointer.restore(template=runner)
            u = int(runner.update_idx)
    return runner
