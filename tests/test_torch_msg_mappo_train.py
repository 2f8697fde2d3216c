"""MAPPO with message bits as a whole, on the CPU: three chained updates of
the port's learner on JAX's split path (the collector's message mode K2b;
the critic values of K6, the rounding of ``_critic_rowmajor_forward``; per
pass the actor's gradient from K4 with the message head and ``vf_coef = 0``
and the critic's from autograd on the window's joint observations; the split
optimizer) against the JAX package's ``build_mappo_train_step(
collect_mode="pallas", interpret=True, deterministic_collect=True)`` on
``msg_bits=2`` (the split path: JAX's combined kernels take no message
head), with the JAX update's window starts handed over, as
``tests/test_torch_mappo_train.py``; and ``train --algo mappo --msg-bits``.

The envs start at staggered step counts, so their episodes end at different
steps: deterministic mode respawns every env that ends at one step into the
same state, and 1,024 envs ending together would repeat each later sample
1,024 times, so that one flipped bf16 rounding moves a window's gradient
coherently.  Each side carries its own env states, observations and update
index from one update to the next.  Two port runners follow the JAX one: the
resynced runner's parameters and optimizer state are set to JAX's before each
update, so each update is compared alone at ``0.05 * lr * P``; the carried
runner keeps its own.  Carried, the two sides drift apart by more than that
after the first update, and so does JAX from itself: the actor has no value
term (``vf_coef = 0``), so most of its first-layer gradients are below Adam's
eps (1e-5), where a gradient that agrees to 3e-5 of its block's largest still
moves a step by a good part of lr.  The carried runner is held to twice the
distance between JAX's run and a JAX run whose initial actor weights were
each moved by one part in 2**23 (about one ulp).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
from rware_tpu.models import mappo as jax_mappo
from rware_tpu.ops.pallas_rollout import ENV_BLOCK
from rware_tpu_torch import train
from rware_tpu_torch.models import mappo
from rware_tpu_torch.models.networks import BlockDims, CriticDims
from tests.test_torch_mappo_train import _configs, _flat_params, _jax_starts, _port_runner
from tests.torch_ref import ALL_FIELDS, assert_fields_equal, compile_bf16_exact, make_pair

torch.set_num_threads(1)

M, N_UPDATES, MAX_STEPS = 2, 3, 100
PARTS = ("actor", "critic")


def _one_ulp(tree, seed):
    """``tree`` with each f32 leaf scaled by 1 +- 2**-23, random signs."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x)
        if x.dtype != np.float32:
            return x
        return jnp.asarray(x * (1 + np.float32(2 ** -23) * np.sign(rng.standard_normal(x.shape)))
                           .astype(np.float32))
    return jax.tree.map(move, tree)


@pytest.fixture(scope="module")
def chained_pair():
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", max_steps=MAX_STEPS,
                                         msg_bits=M).config)
    jcfg, cfg = _configs()
    jrunner, actor, critic, tx = jax_mappo.init_mappo_runner(jenv, jcfg, jax.random.key(1))
    assert actor.msg_bits == M
    steps = np.random.default_rng(0).integers(0, MAX_STEPS, ENV_BLOCK).astype(np.int32)
    jrunner = jrunner.replace(env_states=jrunner.env_states.replace(cur_steps=jnp.asarray(steps)))
    ts = compile_bf16_exact(
        jax_mappo.build_mappo_train_step(jenv, actor, critic, tx, jcfg, collect_mode="pallas",
                                         interpret=True, deterministic_collect=True), jrunner)
    jmoved = jrunner.replace(params={"actor": _one_ulp(jrunner.params["actor"], 5),
                                     "critic": jrunner.params["critic"]})
    runner = carried = _port_runner(jrunner)
    l_obs = env.config.flattened_obs_length
    dims, cdims = BlockDims(l_obs, 128, 128, 5, M), CriticDims(2, l_obs, 128, 128)
    step = mappo.build_mappo_train_step(env, dims, cdims, cfg, deterministic_collect=True)
    history = []
    for u in range(N_UPDATES):
        starts = _jax_starts(jcfg, jrunner)
        synced = _port_runner(jrunner)
        runner = dataclasses.replace(runner, params=synced.params, opt_state=synced.opt_state)
        jrunner, jmetrics = ts(jrunner)
        jmoved, _ = ts(jmoved)
        runner, metrics = step(runner, starts)
        carried, _ = step(carried, starts)
        history.append((jrunner, jmetrics, runner, metrics, carried, jmoved))
    return cfg, history, step


def test_split_path_and_episode_ends(chained_pair):
    _, history, step = chained_pair
    assert isinstance(step.grads, mappo.MappoSplitGrads) and step.update_phase is None
    assert step.grads.actor.launches == step.critic_values.launches == 0  # CPU: plain versions
    done = [int(h[3]["episodes_done"]) for h in history]
    assert done == [int(h[1]["episodes_done"]) for h in history]
    assert min(done) > 50, done  # episodes end in every update


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_resynced_update_matches_jax(chained_pair, u):
    """From JAX's parameters, after each update: env states (messages included) and observations
    equal, both parts' parameters within ``0.05 * lr * P``, ``rtol = 1e-3``,
    optimizer counts and update index equal, metrics within rtol 1e-2 (and
    1e-4, as ``tests/test_torch_mappo_train.py``)."""
    cfg, history, _ = chained_pair
    jrunner, jmetrics, runner, metrics, _, _ = history[u]
    assert_fields_equal(runner.env_states, jrunner.env_states, ALL_FIELDS + ("agent_message",))
    np.testing.assert_array_equal(runner.obs.float().numpy(),
                                  np.asarray(jrunner.obs, dtype=np.float32))
    p = cfg.epochs * cfg.minibatches
    want = _flat_params(jrunner)
    for part in PARTS:
        np.testing.assert_allclose(runner.params[part].numpy(), want[part].numpy(),
                                   atol=0.05 * cfg.lr * p, rtol=1e-3, err_msg=part)
        assert runner.opt_state[part].count == int(jrunner.opt_state[part][1][0].count) \
            == p * (u + 1)
    assert runner.update_idx == int(jrunner.update_idx) == u + 1
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-2, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_carried_update_tracks_jax(chained_pair, u):
    """Each side carrying its own parameters and optimizer state: env states
    (messages included) and observations equal after every update; the first
    update's parameters within ``0.05 * lr * P``, ``rtol = 1e-3``; after each
    later one, each part's largest difference from JAX within twice that of
    the JAX run whose initial actor moved by about one ulp."""
    cfg, history, _ = chained_pair
    jrunner, _, _, _, carried, jmoved = history[u]
    assert_fields_equal(carried.env_states, jrunner.env_states, ALL_FIELDS + ("agent_message",))
    np.testing.assert_array_equal(carried.obs.float().numpy(),
                                  np.asarray(jrunner.obs, dtype=np.float32))
    assert carried.opt_state["actor"].count == cfg.epochs * cfg.minibatches * (u + 1)
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


def test_train_mappo_msg_bits_and_refusals(tmp_path):
    out = train.main(["--device", "cpu", "--algo", "mappo", "--n-envs", "128",
                      "--rollout-len", "8", "--updates", "1", "--msg-bits", "2",
                      "--checkpoint-dir", str(tmp_path)])
    assert np.isfinite(out["v_loss"]) and out["entropy"] > np.log(5)
    ckpt = torch.load(str(tmp_path / "policy.pt"))
    assert ckpt["msg_bits"] == 2 and "critic" in ckpt
    for argv in (["--algo", "mappo", "--fused-critic-phase"],
                 ["--algo", "mappo", "--net", "gru", "--fused-critic-phase"]):
        with pytest.raises(NotImplementedError, match="no such learner"):
            train.main(argv + ["--msg-bits", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="MLP policies only"):
        train.main(["--algo", "seac", "--net", "gru", "--msg-bits", "2", "--device", "cpu"])
