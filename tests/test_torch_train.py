"""The slice as a whole: one update of the port's fused learner against the
JAX package's ``build_pallas_train_step(interpret=True,
deterministic_collect=True)``, from the same env states, parameters and
optimizer state, with the JAX update's window starts injected; several
chained updates of both, each carrying its own runner across episode ends;
and the port's ``train`` / ``evaluate`` entry points on the CPU
(``tests/test_torch_long_obs_train.py`` runs the single update's checks at
sensor range 5).
"""
import jax
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.models import IPPOConfig as JaxConfig
from rware_tpu.models import ippo as jax_ippo
from rware_tpu.models import ippo_pallas as jax_native
from rware_tpu.ops.pallas_rollout import ENV_BLOCK, build_pallas_collect
from rware_tpu.ops.pallas_update import phase_time_block as jax_time_block
from rware_tpu_torch import evaluate, train
from rware_tpu_torch.convert import adam_state_from_optax, params_from_flax
from rware_tpu_torch.models import ActorCritic, ippo
from rware_tpu_torch.models.ippo_fused import build_fused_train_step
from rware_tpu_torch.models.networks import BlockDims
from tests.torch_ref import (
    ALL_FIELDS,
    assert_fields_equal,
    compile_bf16_exact,
    jit_bf16_exact,
    make_pair,
    to_port,
)

torch.set_num_threads(1)

T_LEN, EPOCHS, MINIBATCHES = 8, 2, 2
# chained updates: episodes of MAX_STEPS end inside the 2nd and 3rd updates
N_UPDATES, MAX_STEPS = 3, 12


def _step_pair(env_id):
    jenv, env = make_pair(env_id)
    jcfg = JaxConfig(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS,
                     minibatches=MINIBATCHES)
    jrunner, model, tx = jax_native.init_pallas_runner(jenv, jcfg, jax.random.key(0))
    ts = jax_native.build_pallas_train_step(jenv, model, tx, jcfg, interpret=True,
                                            deterministic_collect=True)
    jnew, jmetrics = jit_bf16_exact(ts, jrunner)
    # the update's windows, and its trajectory in the (T, B, N) layout
    k_perm = jax.random.split(jrunner.key, 2)[1]
    starts = jax_native.phase_window_starts(
        jcfg, T_LEN, jax_time_block(T_LEN // MINIBATCHES), k_perm)
    collect = build_pallas_collect(jenv.config, T_LEN, interpret=True, deterministic=True,
                                   tc_len=T_LEN)
    jstates, jtraj = jit_bf16_exact(lambda s, p: collect(s, p, 0), jrunner.env_states,
                                    jrunner.params)
    obs = jax.vmap(jax_ippo.policy_obs_fn(jenv))(jstates)
    _, last = jit_bf16_exact(model.apply, jrunner.params, obs)
    jadv, _ = jax_ippo.compute_gae(jcfg, jtraj["reward"], jtraj["value"], jtraj["done"], last)

    cfg = ippo.IPPOConfig(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS,
                          minibatches=MINIBATCHES)
    np_params = jax.tree.map(np.asarray, jrunner.params)
    theta = params_from_flax(np_params)
    runner = ippo.RunnerState(
        params=theta, opt_state=adam_state_from_optax(jax.tree.map(np.asarray, jrunner.opt_state)),
        env_states=to_port(jrunner.env_states), obs=None, generator=torch.Generator(),
        update_idx=0, seed=0)
    dims = BlockDims(env.config.flattened_obs_length, 128, 128, 5)
    step = build_fused_train_step(env, dims, cfg, deterministic_collect=True)
    starts_t = torch.from_numpy(np.array(starts)).to(torch.int64)
    new, metrics = step(runner, starts_t)
    states, traj = step.rollout(runner)
    obs, adv, _ = step.advantages(runner, states, traj)
    return dict(jnew=jnew, jmetrics=jmetrics, jtraj=jtraj, jadv=jadv, jlast=last, runner=runner,
                new=new, metrics=metrics, traj=traj, adv=adv,
                last=ippo.last_values(dims, theta, obs), step=step, cfg=cfg)


@pytest.fixture(scope="module")
def step_pair():
    return _step_pair("rware-tiny-2ag-v2")


def test_trajectory_equals_jax(step_pair):
    traj, jtraj = step_pair["traj"], step_pair["jtraj"]
    np.testing.assert_array_equal(traj["obs"].float().numpy(),
                                  np.asarray(jtraj["obs"], dtype=np.float32))
    for k in ("action", "reward"):
        np.testing.assert_array_equal(traj[k].numpy(), np.asarray(jtraj[k]), err_msg=k)
    np.testing.assert_array_equal(traj["done"].numpy(), np.asarray(jtraj["done"]).astype(bool))


def _check_advantages(step_pair, last_atol):
    vdiff = np.abs(step_pair["traj"]["value"].numpy() - np.asarray(step_pair["jtraj"]["value"]))
    ldiff = np.abs(step_pair["last"].numpy() - np.asarray(step_pair["jlast"]))
    assert vdiff.mean() < 1e-6 and vdiff.max() < 1e-3 and ldiff.max() < last_atol
    agree = (vdiff.max(axis=(0, 2)) < 1e-6) & (ldiff.max(axis=1) < 1e-6)
    assert agree.mean() > 0.98, agree.mean()
    adiff = np.abs(step_pair["adv"].numpy() - np.asarray(step_pair["jadv"]))
    assert adiff[:, agree].max() < 1e-5
    assert adiff.max() < 1e-3


def test_advantages_match_jax(step_pair):
    """Advantages within 1e-5 in every env whose stored and last values
    agree with JAX's to 1e-6.  The two collectors sum the MLP in different
    orders, so a hidden unit's bf16 rounding flips now and then (a value
    moves by up to a few 1e-4); such envs are few, and bounded by that."""
    _check_advantages(step_pair, 1e-5)


def test_update_matches_jax(step_pair):
    new, jnew, cfg = step_pair["new"], step_pair["jnew"], step_pair["cfg"]
    p = cfg.epochs * cfg.minibatches
    want = params_from_flax(jax.tree.map(np.asarray, jnew.params))
    np.testing.assert_allclose(new.params.numpy(), want.numpy(), atol=0.05 * cfg.lr * p,
                               rtol=1e-3)
    assert new.opt_state.count == int(jnew.opt_state[1][0].count) == p
    assert new.update_idx == int(jnew.update_idx) == 1
    for k, v in step_pair["metrics"].items():
        np.testing.assert_allclose(float(v), float(step_pair["jmetrics"][k]), rtol=1e-2,
                                   atol=1e-6, err_msg=k)


def test_update_moved_params_and_runner_is_new(step_pair):
    runner, new = step_pair["runner"], step_pair["new"]
    assert float((new.params - runner.params).abs().max()) > 0
    assert runner.update_idx == 0 and runner.opt_state.count == 0  # the input is untouched
    assert step_pair["step"].update_phase.launches == 0  # CPU: the plain version


@pytest.fixture(scope="module")
def chained_pair():
    """N_UPDATES updates of each learner, each carrying its own runner (env
    states, observations, parameters, optimizer state, update index) from
    one update to the next; only the window starts go from JAX to the port.
    """
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", max_steps=MAX_STEPS).config)
    jcfg = JaxConfig(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS,
                     minibatches=MINIBATCHES)
    jrunner, model, tx = jax_native.init_pallas_runner(jenv, jcfg, jax.random.key(1))
    ts = compile_bf16_exact(
        jax_native.build_pallas_train_step(jenv, model, tx, jcfg, interpret=True,
                                           deterministic_collect=True), jrunner)
    cfg = ippo.IPPOConfig(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS,
                          minibatches=MINIBATCHES)
    runner = ippo.RunnerState(
        params=params_from_flax(jax.tree.map(np.asarray, jrunner.params)),
        opt_state=adam_state_from_optax(jax.tree.map(np.asarray, jrunner.opt_state)),
        env_states=to_port(jrunner.env_states), obs=None, generator=torch.Generator(),
        update_idx=0, seed=0)
    step = build_fused_train_step(env, BlockDims(env.config.flattened_obs_length, 128, 128, 5),
                                  cfg, deterministic_collect=True)
    history = []
    for _ in range(N_UPDATES):
        k_perm = jax.random.split(jrunner.key, 2)[1]
        starts = jax_native.phase_window_starts(
            jcfg, T_LEN, jax_time_block(T_LEN // MINIBATCHES), k_perm)
        jrunner, jmetrics = ts(jrunner)
        runner, metrics = step(runner, torch.from_numpy(np.array(starts)).to(torch.int64))
        history.append((jrunner, jmetrics, runner, metrics))
    return cfg, history


def test_chained_updates_cross_episode_ends(chained_pair):
    _, history = chained_pair
    done = [int(h[3]["episodes_done"]) for h in history]
    assert done == [int(h[1]["episodes_done"]) for h in history]
    assert done[0] == 0 and min(done[1:]) == ENV_BLOCK, done


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_chained_update_matches_jax(chained_pair, u):
    """After each update: env states and observations equal, parameters
    within the K3 bounds, optimizer count and update index equal, metrics
    within rtol 1e-2."""
    cfg, history = chained_pair
    jrunner, jmetrics, runner, metrics = history[u]
    assert_fields_equal(runner.env_states, jrunner.env_states, ALL_FIELDS)
    np.testing.assert_array_equal(runner.obs.float().numpy(),
                                  np.asarray(jrunner.obs, dtype=np.float32))
    p = cfg.epochs * cfg.minibatches
    want = params_from_flax(jax.tree.map(np.asarray, jrunner.params))
    np.testing.assert_allclose(runner.params.numpy(), want.numpy(), atol=0.05 * cfg.lr * p,
                               rtol=1e-3)
    assert runner.opt_state.count == int(jrunner.opt_state[1][0].count) == p * (u + 1)
    assert runner.update_idx == int(jrunner.update_idx) == u + 1
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-2, atol=1e-6,
                                   err_msg=k)


def test_train_and_evaluate_entry_points(tmp_path):
    out = train.main(["--device", "cpu", "--n-envs", "128", "--rollout-len", "8",
                      "--updates", "2", "--log-every", "1",
                      "--checkpoint-dir", str(tmp_path)])
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl", "reward_per_env",
              "episodes_done", "env_steps_per_s"):
        assert np.isfinite(out[k]), k
    env_id, policy = train.load_policy(str(tmp_path / "policy.pt"))
    assert env_id == "rware-tiny-2ag-v2"
    runner, dims = ippo.init_runner(rware_tpu_torch.make(env_id, device="cpu"), ippo.IPPOConfig(n_envs=1), 0)
    assert not torch.equal(ippo.policy_of(dims, runner.params).dense[0].weight,
                           policy.dense[0].weight)  # trained away from the init
    stats = evaluate.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path),
                           "--episodes", "8", "--max-steps", "40"])
    assert stats["episodes"] == 8 and np.isfinite(stats["mean_return"])
    assert stats["mean_length"] <= 40


def test_mean_return_counts_until_the_first_episode_end():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", max_steps=10, device="cpu")
    policy = ActorCritic(env.config.flattened_obs_length)
    stats = evaluate.mean_return(env, policy, episodes=4, max_steps=25)
    assert stats["mean_length"] == 10 and stats["unfinished"] == 0


def test_entry_points_refuse_what_is_not_there():
    with pytest.raises(ValueError, match="MLP policies only"):
        train.main(["--algo", "seac", "--net", "gru", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="no such learner"):
        train.main(["--algo", "mappo", "--net", "gru", "--collect", "plain", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="no such learner"):
        train.main(["--algo", "mappo", "--net", "gru", "--fused-critic-phase", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--device", "cuda", "--updates", "1"])
