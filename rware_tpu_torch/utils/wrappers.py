"""Gymnasium wrappers over the adapter env (a copy of
``rware_tpu/utils/wrappers.py``).

Behavioral equivalents of the reference wrappers
(the reference's ``rware/utils/wrappers.py``): FlattenAgents collapses the
multi-agent interface into one flat vector + joint action space with summed
reward; DictAgents re-keys everything by ``agent_i``; FlattenSAObservation
flattens each agent's observation independently.
"""
from __future__ import annotations

import math

import gymnasium as gym
import numpy as np

from rware_tpu_torch.types import Action


class FlattenAgents(gym.Wrapper):
    """Single-agent view: concatenated obs, joint action, summed reward."""

    def __init__(self, env):
        super().__init__(env)
        msg_bits = env.unwrapped.config.msg_bits
        per_agent = [len(Action), *msg_bits * (2,)]
        n_agents = env.unwrapped.n_agents
        if len(per_agent) == 1 and n_agents == 1:
            self.action_space = gym.spaces.Discrete(per_agent[0])
        else:
            self.action_space = gym.spaces.MultiDiscrete(n_agents * per_agent)
        self.observation_space = gym.spaces.Tuple(
            tuple(space for space in env.observation_space)
        )

    def _flatten(self, observation):
        return np.concatenate(
            [
                gym.spaces.flatten(s, o)
                for s, o in zip(self.observation_space, observation)
            ]
        ).astype(np.float32)

    def reset(self, **kwargs):
        observation, info = super().reset(**kwargs)
        return self._flatten(observation), info

    def step(self, action):
        n = self.unwrapped.n_agents
        if np.ndim(action):
            # per-agent slices keep width 1+msg_bits (reference uses
            # np.split, rware/utils/wrappers.py:33); squeeze only scalars
            action = [np.squeeze(a) if a.size == 1 else a
                      for a in np.split(np.asarray(action), n)]
        else:
            action = [action]
        observation, reward, done, truncated, info = super().step(list(action))
        return self._flatten(observation), float(np.sum(reward)), done, truncated, info


class DictAgents(gym.Wrapper):
    """agent_0.. keyed dicts for obs/reward/done/truncated."""

    def _keys(self):
        n = self.unwrapped.n_agents
        digits = int(math.log10(n)) + 1
        return [f"agent_{i:{digits}}" for i in range(n)]

    def reset(self, **kwargs):
        observation, info = super().reset(**kwargs)
        return dict(zip(self._keys(), observation)), info

    def step(self, action):
        keys = self._keys()
        assert keys == sorted(action.keys())
        acts = [action[k] for k in keys]
        observation, reward, done, truncated, info = super().step(acts)
        return (
            dict(zip(keys, observation)),
            dict(zip(keys, reward)),
            {k: done for k in keys},
            {k: truncated for k in keys},
            info,
        )


class FlattenSAObservation(gym.ObservationWrapper):
    """Flatten each agent's observation independently."""

    def __init__(self, env):
        super().__init__(env)
        ma_spaces = []
        for sa_obs in env.observation_space:
            flatdim = gym.spaces.flatdim(sa_obs)
            ma_spaces.append(
                gym.spaces.Box(-np.inf, np.inf, shape=(flatdim,), dtype=np.float32)
            )
        self.observation_space = gym.spaces.Tuple(tuple(ma_spaces))

    def observation(self, observation):
        return [
            gym.spaces.flatten(s, o)
            for s, o in zip(self.env.observation_space, observation)
        ]
