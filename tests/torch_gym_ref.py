"""Helpers of the Gymnasium-surface tests: both packages' adapters run from
one state under the same actions."""
import dataclasses

import gymnasium as gym
import numpy as np
import pytest
import torch

import rware_tpu.gym_adapter as jax_gym
import rware_tpu_torch
import rware_tpu_torch.gym_adapter as port_gym
from rware_tpu_torch.core.host import to_host
from tests.torch_ref import check_queue_rule, to_port


@pytest.fixture(autouse=True)
def restore_registry():
    """Every test leaves ``gym.registry`` as it found it."""
    saved = dict(gym.registry)
    yield
    gym.registry.clear()
    gym.registry.update(saved)


def assert_tree_equal(got, want, path="obs"):
    """Equal nested tuples / lists / dicts of arrays and numbers, dtypes
    of arrays included."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (path, got, want)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def pair(env_id_or_config="rware-tiny-2ag-v2", **overrides):
    """(JAX env, port env on the CPU) of one id or config."""
    jenv = jax_gym.make_gym(env_id_or_config, **overrides)
    if not isinstance(env_id_or_config, str):
        env_id_or_config = rware_tpu_torch.WarehouseConfig(
            **dataclasses.asdict(env_id_or_config))
    return jenv, port_gym.make_gym(env_id_or_config, device="cpu", **overrides)


def reset_pair(jenv, penv, seed=0):
    """Reset JAX's env and inject its state into the port's; their
    observations."""
    jobs, jinfo = jenv.reset(seed=seed)
    penv.reset(seed=seed)
    penv.state = to_port(jenv.state, batched=False)
    return jobs, penv._convert_obs(penv._env.observe(penv.state))


def step_pair(jenv, penv, actions):
    """One step of both envs: every output equal (the observation after
    JAX's queue is carried on where the queue was resampled)."""
    q_before = np.asarray(jenv.state.request_queue)
    jout = jenv.step(actions)
    pout = penv.step(actions)
    q_jax = np.asarray(jenv.state.request_queue)
    q_port = to_host(penv.state.request_queue[0])[0]
    check_queue_rule(q_before, q_jax, q_port, jenv.config.n_shelves)
    for got, want in zip(pout[1:], jout[1:]):
        assert_tree_equal(got, want, "step output")
    penv.state = penv.state.replace(request_queue=torch.from_numpy(q_jax.copy())[None])
    pobs = pout[0]
    if not np.array_equal(q_port, q_jax):
        pobs = penv._convert_obs(penv._env.observe(penv.state))
    assert_tree_equal(pobs, jout[0])
    return pout[:1] + (pobs,) + pout[1:]
