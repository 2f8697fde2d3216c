"""Checkpoint / resume (the counterpart of ``rware_tpu/checkpoint.py``).

The whole training state is one runner (``RunnerState``, ``RNNRunnerState``
or MAPPO's): parameters, Adam moments and count, the env-batch state, the
GRU carry, the ``torch.Generator`` that draws the minibatches, the run seed
that keys the collectors' Philox streams, and the update index.  A
checkpoint is that runner as one nested dict of CPU tensors and Python
scalars, written with ``torch.save`` to ``<directory>/<step>.pt``; restoring
it into a template runner puts every tensor back on the template's device,
so resuming a run reproduces the updates it would have taken unbroken, bit
for bit on one device (``tests/test_torch_checkpoint.py``).

In a data-parallel run of world size W > 1 each rank writes its own file for
a step, ``<step>.rank<r>-of<W>.pt``: its runner holds its env shard, and the
replicated parts are the same in every file.  A step is complete once every
rank's file exists; only complete steps are listed and restored, and a
directory written at another world size is refused.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Optional

import torch

_GENERATOR = "__generator_state__"


def pack(tree: Any) -> Any:
    """A runner (dataclasses, dicts, tuples, tensors, generators, scalars)
    as nested dicts and lists of CPU tensors and scalars, which
    ``torch.load(weights_only=True)`` reads back."""
    if dataclasses.is_dataclass(tree):
        return {f.name: pack(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: pack(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [pack(v) for v in tree]
    if isinstance(tree, torch.Generator):
        return {_GENERATOR: tree.get_state()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def unpack(saved: Any, template: Any) -> Any:
    """Inverse of :func:`pack` in the structure of ``template``: each tensor
    on its template tensor's device, each generator a new one in the saved
    state."""
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: unpack(saved[f.name], getattr(template, f.name))
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: unpack(saved[k], v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(unpack(s, t) for s, t in zip(saved, template))
    if isinstance(template, torch.Generator):
        gen = torch.Generator(device=template.device)
        gen.set_state(saved[_GENERATOR])
        return gen
    if isinstance(template, torch.Tensor):
        return saved.to(template.device)
    return saved


_NAME = re.compile(r"^(\d+)(?:\.rank(\d+)-of(\d+))?\.pt$")


class Checkpointer:
    """Numbered step checkpoints under one directory; the oldest beyond
    ``max_to_keep`` (None: all kept) are deleted.  ``rank`` of ``world``
    (1: one file a step) is the writer's place in a data-parallel run."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3, rank: int = 0,
                 world: int = 1):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not in a world of {world}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.rank, self.world = rank, world
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int, rank: Optional[int] = None) -> str:
        if self.world == 1:
            return os.path.join(self.directory, f"{step}.pt")
        rank = self.rank if rank is None else rank
        return os.path.join(self.directory, f"{step}.rank{rank}-of{self.world}.pt")

    def _files(self) -> dict:
        """{world size: {step: set of ranks}} of the files in the directory."""
        out: dict = {}
        for name in os.listdir(self.directory):
            m = _NAME.match(name)
            if m:
                world = int(m.group(3) or 1)
                out.setdefault(world, {}).setdefault(int(m.group(1)), set()).add(
                    int(m.group(2) or 0))
        return out

    def steps(self) -> list:
        """The complete steps (every rank's file written), in ascending order."""
        mine = self._files().get(self.world, {})
        return sorted(step for step, ranks in mine.items() if len(ranks) == self.world)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, runner: Any) -> None:
        """Write this rank's ``runner`` as step ``step`` (atomically: a
        temporary file renamed into place); delete this rank's files of the
        steps before the last ``max_to_keep``."""
        tmp = self._path(step) + ".tmp"
        torch.save(pack(runner), tmp)
        os.replace(tmp, self._path(step))
        if self.max_to_keep is not None:
            own = sorted(s for s, ranks in self._files().get(self.world, {}).items()
                         if self.rank in ranks)
            for old in own[:-self.max_to_keep]:
                os.remove(self._path(old))

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        """The runner saved at ``step`` (the latest if None), in the
        structure and on the devices of ``template``; without a template,
        the nested dicts :func:`pack` wrote, on the CPU."""
        other = sorted(w for w in self._files() if w != self.world)
        if other and not self.steps():
            raise ValueError(f"{self.directory} holds checkpoints of world size {other[0]}; "
                             f"this run has world size {self.world}")
        if step is None:
            step = self.latest_step
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        saved = torch.load(self._path(step), map_location="cpu", weights_only=True)
        return saved if template is None else unpack(saved, template)
