"""Data parallelism over the env batch with ``torch.distributed`` (the
counterpart of ``rware_tpu/parallel/sharding.py``).

The JAX package shards the env axis of a device ``Mesh``.  Here one process
drives one device (``rank`` of ``world``) and holds a contiguous shard of the
global env batch; parameters, optimizer state and the runner's generator are
the same on every rank.  A learner built with a :class:`Mesh` collects its own
rows (keyed by their global env indices) with no collective, and its
statistics follow JAX's, which differ by learner:

* The five learners JAX builds with ``mesh=`` run under ``shard_map``, where
  every statistic a learner takes over its batch (the advantages' mean and
  std) is the shard's own: each minibatch pass leaves its gradients and
  metrics through :func:`data_parallel`, one packed all-reduce of their mean
  over the ranks, and the update's reward and episode sums through
  :func:`psum`.
* The learners JAX only places on the mesh (plain IPPO, plain recurrent
  IPPO, SEAC-PPO's two MLP learners, SEAC A2C) keep their single-device
  meaning under XLA's partitioner: every statistic is the whole batch's.  A
  pass's minibatch is drawn from the global batch (the same generator on
  every rank) and :func:`rank_rows` picks this rank's rows of it; each
  pass's advantage moments (:func:`row_moments`) and the update's reward and
  episode sums leave in one float64 all-reduce before the first pass
  (:func:`whole_batch_stats`); a rank's loss is its partial sum over the
  global count, and each pass's gradients and metrics leave as their sum
  over the ranks (:func:`data_parallel` with ``reduce="sum"``).  SEAC-PPO's
  time windows and SEAC A2C's rollout split evenly, so their shard means
  average to the whole batch's.

Every collective of a learner goes through a :class:`Mesh` and adds one to
its ``counts``, which tests and ``chip_smoke.py`` zero before a run.  The
collectives take the tensors on the mesh's device, CUDA tensors under NCCL
and gloo alike, and raise what the backend raises.  The backend is the
process group's own: nothing here picks one.  Without a mesh a learner is a
world of one: the same formulas, no collective.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

ENV_AXIS = "env"


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` applied to every tensor of ``tree`` (dataclasses, dicts, lists,
    tuples and named tuples of tensors); other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def _leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def _rebuild(tree: Any, leaves: List[torch.Tensor]) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


@dataclasses.dataclass
class Mesh:
    """One rank's view of a 1-D data-parallel mesh over ``world`` processes:
    its process ``group`` (None: the default group), ``rank``, ``world``
    and ``device``.  ``counts`` holds the collectives it ran."""

    group: Any
    rank: int
    world: int
    device: torch.device
    counts: dict = dataclasses.field(default_factory=lambda: {"all_reduce": 0, "broadcast": 0})

    def __post_init__(self):
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} is not in a world of {self.world}")
        self.device = torch.device(self.device)

    def n_local(self, n_envs: int) -> int:
        """Envs a rank holds; refuses a batch the world does not divide."""
        if n_envs % self.world:
            raise ValueError(f"n_envs={n_envs} is not divisible by the world size {self.world}")
        return n_envs // self.world

    def env_offset(self, n_envs: int) -> int:
        """The global index of this rank's first env."""
        return self.rank * self.n_local(n_envs)

    def env_slice(self, n_envs: int) -> slice:
        """This rank's contiguous rows ``[rank * n, (rank + 1) * n)`` of a
        global batch of ``n_envs``, n = n_envs / world."""
        start = self.env_offset(n_envs)
        return slice(start, start + self.n_local(n_envs))

    def reset_counts(self) -> None:
        for k in self.counts:
            self.counts[k] = 0

    # -- the transport: the only place a collective runs ------------------------

    def _run(self, kind: str, buf: torch.Tensor, **kw) -> None:
        import torch.distributed as dist

        fn = dist.all_reduce if kind == "all_reduce" else dist.broadcast
        self.counts[kind] += 1
        fn(buf, group=self.group, **kw)

    def _all_reduce_sum(self, buf: torch.Tensor) -> None:
        """In place: the elementwise sum of ``buf`` over the ranks."""
        import torch.distributed as dist

        self._run("all_reduce", buf, op=dist.ReduceOp.SUM)

    def _broadcast(self, buf: torch.Tensor, src: int = 0) -> None:
        """In place: rank ``src``'s ``buf`` on every rank."""
        self._run("broadcast", buf, src=src)

    # -- the collectives of a learner --------------------------------------------

    def _reduce(self, tree: Any, mean: bool, dtype: Optional[torch.dtype]) -> Any:
        leaves = _leaves(tree)
        if not leaves:
            return tree
        if dtype is None:
            dtype = leaves[0].dtype
            if any(x.dtype != dtype for x in leaves):
                raise ValueError("the tensors of one all-reduce mean must share one dtype")
        buf = torch.cat([x.detach().reshape(-1).to(self.device, dtype) for x in leaves])
        self._all_reduce_sum(buf)
        if mean:
            buf = buf / self.world
        out, at = [], 0
        for x in leaves:
            out.append(buf[at:at + x.numel()].reshape(x.shape).to(x.dtype))
            at += x.numel()
        return _rebuild(tree, out)

    def all_reduce_sum(self, tree: Any) -> Any:
        """Every tensor of ``tree`` (float32 partial gradients and metrics)
        replaced by its sum over the ranks: one all-reduce of them packed
        together."""
        return self._reduce(tree, False, None)

    def all_reduce_mean(self, tree: Any) -> Any:
        """Every tensor of ``tree`` (float32 gradients and metrics) replaced
        by its mean over the ranks: one all-reduce of them packed together
        (the sum, then one division by the world size)."""
        return self._reduce(tree, True, None)

    def psum(self, tree: Any) -> Any:
        """Every tensor of ``tree`` replaced by its sum over the ranks: one
        all-reduce of them packed as float64 (integer counts stay exact, a
        float32 sum of two ranks rounds once)."""
        return self._reduce(tree, False, torch.float64)


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of an initialised process group (the default group if None)
    on ``device`` (this rank's; the CPU if None): its rank and world size
    are the group's."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group "
                           "(rware_tpu_torch.distributed.initialize)")
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                torch.device("cpu") if device is None else device)


def shard_env_batch(tree: Any, mesh: Mesh) -> Any:
    """This rank's contiguous rows of every tensor of ``tree``, a full batch
    that every rank holds alike (the same seeds), on the mesh's device."""
    return tree_map(lambda x: x[mesh.env_slice(x.shape[0])].to(mesh.device), tree)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Rank 0's values of ``tree`` on every rank (its tensors, and the state
    of its ``torch.Generator`` objects), one broadcast a tensor, on the
    mesh's device; run once at set-up."""

    def bcast(x: torch.Tensor) -> torch.Tensor:
        buf = x.detach().to(mesh.device).clone()
        mesh._broadcast(buf)
        return buf

    def walk(node):
        if isinstance(node, torch.Generator):
            gen = torch.Generator(device=node.device)
            gen.set_state(bcast(node.get_state()).cpu())
            return gen
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{f.name: walk(getattr(node, f.name))
                                                for f in dataclasses.fields(node)})
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if isinstance(node, torch.Tensor):
            return bcast(node).to(node.device)
        return node

    return walk(tree)


def data_parallel(grads_fn: Callable[..., Tuple[Any, Any]], mesh: Optional[Mesh],
                  reduce: str = "mean") -> Callable[..., Tuple[Any, Any]]:
    """``grads_fn(...) -> (grads, metrics)`` of one minibatch pass on this
    rank's shard, wrapped so that its gradients and metrics leave as one
    packed all-reduce.  ``reduce="mean"`` takes their mean over the ranks:
    JAX's per-pass ``pmean`` inside ``shard_map`` (the five mesh learners,
    each shard with its own statistics), and the exact whole-batch mean where
    every rank holds an equal share of the pass (SEAC-PPO's time windows,
    SEAC A2C).  ``reduce="sum"`` takes their sum, for a loss that is already
    a partial sum over the global count (plain IPPO, plain recurrent IPPO,
    SEAC-PPO's flat minibatches).  Without a mesh, ``grads_fn``."""
    if reduce not in ("mean", "sum"):
        raise ValueError(f"reduce must be 'mean' or 'sum', got {reduce!r}")
    if mesh is None:
        return grads_fn
    combine = mesh.all_reduce_mean if reduce == "mean" else mesh.all_reduce_sum

    def fn(*args, **kwargs):
        return combine(grads_fn(*args, **kwargs))

    return fn


def rank_rows(idx: torch.Tensor, n_envs: int, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's rows of a minibatch of global rows ``idx`` (row ``t *
    n_envs + b`` is env b at time t; a minibatch of envs has t = 0), as
    indices into its own ``(T * n_local)`` rows, in ``idx``'s order; empty
    where it holds none.  Without a mesh, ``idx``."""
    if mesh is None:
        return idx
    n, lo = mesh.n_local(n_envs), mesh.env_offset(n_envs)
    t, b = idx // n_envs, idx % n_envs - lo
    keep = (b >= 0) & (b < n)
    return t[keep] * n + b[keep]


def row_moments(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``(x.shape[dim], 3)`` float64: [count, sum, sum of squares] of the
    elements of each row of ``x`` along ``dim``; a pass's advantage moments
    are the sum of its rows'."""
    rows = x.detach().movedim(dim, 0).reshape(x.shape[dim], -1).double()
    count = torch.full((rows.shape[0],), float(rows.shape[1]), dtype=torch.float64,
                       device=x.device)
    return torch.stack([count, rows.sum(1), (rows * rows).sum(1)], 1)


def whole_batch_stats(moments: torch.Tensor, passes: List[torch.Tensor], sums: Any,
                      mesh: Optional[Mesh]):
    """The one float64 all-reduce of an update with whole-batch statistics:
    every pass's advantage moments on this rank (the rows ``passes[p]`` of
    the per-row ``moments`` of :func:`row_moments`, summed) and the tensors
    of ``sums`` (a learner's reward and episode sums on this rank), packed
    (:func:`psum`).  Returns ``(advstats, counts, sums)``: each pass's
    [mean, 1 / (std + 1e-8)] (P, 2) float32 over its whole minibatch
    (population std), its element count (P,) float32, and ``sums`` over the
    whole batch."""
    per_pass = torch.stack([moments.index_select(0, idx.to(moments.device)).sum(0)
                            for idx in passes])
    per_pass, sums = psum((per_pass, sums), mesh)
    n, mean = per_pass[:, 0], per_pass[:, 1] / per_pass[:, 0]
    std = (per_pass[:, 2] / n - mean * mean).clamp(min=0).sqrt()
    advstats = torch.stack([mean, 1.0 / (std + 1e-8)], 1).to(torch.float32)
    return advstats, n.to(torch.float32), sums


def psum(tree: Any, mesh: Optional[Mesh]) -> Any:
    """:meth:`Mesh.psum` of ``tree``; without a mesh, ``tree``."""
    return tree if mesh is None else mesh.psum(tree)


def refuse_under_mesh(mesh: Optional[Mesh], what: str, reason: str) -> None:
    """Raise where ``mesh`` is given: ``what`` cannot run data-parallel."""
    if mesh is not None:
        raise ValueError(f"{what} cannot run under a mesh: {reason}")
