"""Three chained per-pass updates of the port's MAPPO learner against the JAX
package's ``build_mappo_train_step(interpret=True, deterministic_collect=True,
fused_critic_update=True)`` at sensor range 5 (``rware-5s-tiny-2ag-v2``: 855
features a row, the actor's collector with its weights in device memory, the
critic's joint row 1,710), on the CPU, with the JAX update's window starts
handed over, as ``tests/test_torch_mappo_train.py`` at tiny-2ag.

Each side carries its own env states, observations and update index.  Two
port runners follow the JAX one, as in ``tests/test_torch_msg_mappo_train.py``:
the resynced runner's parameters and optimizer state are set to JAX's before
each update, so each update is held alone to tiny-2ag's bounds (``0.05 * lr *
P``, ``rtol = 1e-3``; metrics rtol 1e-2, atol 1e-4); the carried runner keeps
its own, and after its first update is held to twice the distance between
JAX's run and a JAX run whose initial actor weights were each moved by about
one ulp.  Carried, a few first-layer weights drift past tiny-2ag's bound after
the first update (9 and 23 of 126,854 after the second and third): most of
the 855 features are zero on most steps, so their weights' gradients sit
below Adam's eps, where a gradient that agrees to a few ulp still moves a step
by a good part of lr.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import rware_tpu
from rware_tpu.models import mappo as jax_mappo
from rware_tpu_torch.models import mappo
from tests import test_torch_mappo_train as tiny
from tests.test_torch_mappo_train import (
    MAX_STEPS,
    N_UPDATES,
    PARTS,
    _configs,
    _dims,
    _flat_params,
    _jax_starts,
    _port_runner,
)
from tests.test_torch_msg_mappo_train import _one_ulp
from tests.torch_ref import compile_bf16_exact, make_pair

torch.set_num_threads(1)

ENV_ID = "rware-5s-tiny-2ag-v2"


@pytest.fixture(scope="module")
def long_chained_pair():
    jenv, env = make_pair(rware_tpu.make(ENV_ID, max_steps=MAX_STEPS).config)
    jcfg, cfg = _configs()
    jrunner, actor, critic, tx = jax_mappo.init_mappo_runner(jenv, jcfg, jax.random.key(1))
    ts = compile_bf16_exact(
        jax_mappo.build_mappo_train_step(jenv, actor, critic, tx, jcfg, interpret=True,
                                         deterministic_collect=True, fused_critic_update=True,
                                         fused_critic_phase=False), jrunner)
    jmoved = jrunner.replace(params={"actor": _one_ulp(jrunner.params["actor"], 5),
                                     "critic": jrunner.params["critic"]})
    runner = carried = first = _port_runner(jrunner)
    dims, cdims = _dims(env)
    step = mappo.build_mappo_train_step(env, dims, cdims, cfg, deterministic_collect=True)
    history, carried_history = [], []
    for _ in range(N_UPDATES):
        starts = _jax_starts(jcfg, jrunner)
        synced = _port_runner(jrunner)
        runner = dataclasses.replace(runner, params=synced.params, opt_state=synced.opt_state)
        jrunner, jmetrics = ts(jrunner)
        jmoved, _ = ts(jmoved)
        runner, metrics = step(runner, starts)
        carried, _ = step(carried, starts)
        history.append((jrunner, jmetrics, runner, metrics))
        carried_history.append((carried, jmoved))
    return cfg, history, first, step, False, carried_history


def test_collector_takes_the_device_memory_route(long_chained_pair):
    plan = long_chained_pair[3].collect.plan
    assert plan.weights_global and plan.kx == 0


def test_chained_updates_cross_episode_ends_at_sensor_range_5(long_chained_pair):
    tiny.test_chained_updates_cross_episode_ends(long_chained_pair[:5])


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_resynced_update_matches_jax_at_sensor_range_5(long_chained_pair, u):
    tiny.test_chained_update_matches_jax(long_chained_pair[:5], u)


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_carried_update_tracks_jax_at_sensor_range_5(long_chained_pair, u):
    cfg, history, _, _, _, carried_history = long_chained_pair
    jrunner = history[u][0]
    carried, jmoved = carried_history[u]
    np.testing.assert_array_equal(carried.obs.float().numpy(),
                                  np.asarray(jrunner.obs, dtype=np.float32))
    want, moved = _flat_params(jrunner), _flat_params(jmoved)
    for part in PARTS:
        drift = float((carried.params[part] - want[part]).abs().max())
        spread = float((moved[part] - want[part]).abs().max())
        print(f"update {u + 1} {part}: |port - JAX| {drift:.4g}, |JAX one ulp - JAX| {spread:.4g}")
        if u == 0:
            np.testing.assert_allclose(carried.params[part].numpy(), want[part].numpy(),
                                       atol=0.05 * cfg.lr * cfg.epochs * cfg.minibatches,
                                       rtol=1e-3, err_msg=part)
        else:
            assert 0 < drift <= 2 * spread, (part, drift, spread)
