"""Multi-agent space helpers (a copy of ``rware_tpu/utils/spaces.py``;
reference: rware/utils/spaces.py).

``list`` subclasses with per-agent ``sample``/``contains`` — exported for
user code that consumed them from the reference; the env itself uses
``gym.spaces.Tuple``.
"""
from __future__ import annotations

import gymnasium as gym


class MultiAgentObservationSpace(list):
    def __init__(self, ma_space):
        for x in ma_space:
            assert isinstance(x, gym.spaces.Space)
        super().__init__(ma_space)

    def sample(self):
        return [sa_space.sample() for sa_space in self]

    def contains(self, obs):
        return all(space.contains(ob) for space, ob in zip(self, obs))


class MultiAgentActionSpace(list):
    def __init__(self, ma_space):
        for x in ma_space:
            assert isinstance(x, gym.spaces.Space)
        super().__init__(ma_space)

    def sample(self):
        return [sa_space.sample() for sa_space in self]
