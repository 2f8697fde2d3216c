"""The MAPPO slice as a whole: updates of the port's MAPPO learner against the
JAX package's ``build_mappo_train_step(interpret=True,
deterministic_collect=True, fused_critic_update=True)``, per pass (K5) and
whole phase (K7), from the same env states, parameters and split optimizer
state, with the JAX update's window starts injected; three chained updates of
both, each carrying its own runner across episode ends; and the port's
``train --algo mappo`` / ``evaluate`` entry points on the CPU
(``tests/test_torch_long_obs_mappo_train.py`` runs the chained per-pass
updates at sensor range 5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.models import IPPOConfig as JaxConfig
from rware_tpu.models import ippo as jax_ippo
from rware_tpu.models import ippo_pallas as jax_native
from rware_tpu.models import mappo as jax_mappo
from rware_tpu.ops.pallas_rollout import ENV_BLOCK, LANE, build_pallas_collect
from rware_tpu.ops.pallas_update import build_fused_critic_values as jax_values
from rware_tpu.ops.pallas_update import phase_time_block as jax_time_block
from rware_tpu_torch import evaluate, train
from rware_tpu_torch.convert import (
    critic_params_from_flax,
    mappo_opt_state_from_optax,
    params_from_flax,
)
from rware_tpu_torch.models import ippo, mappo
from rware_tpu_torch.models.networks import BlockDims, CentralCritic, CriticDims
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
PARTS = ("actor", "critic")


def _configs():
    kw = dict(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS, minibatches=MINIBATCHES)
    return JaxConfig(**kw), ippo.IPPOConfig(**kw)


def _flat_params(jrunner):
    np_params = jax.tree.map(np.asarray, jrunner.params)
    return {"actor": params_from_flax(np_params["actor"]),
            "critic": critic_params_from_flax(np_params["critic"])}


def _port_runner(jrunner):
    return ippo.RunnerState(
        params=_flat_params(jrunner),
        opt_state=mappo_opt_state_from_optax(jax.tree.map(np.asarray, jrunner.opt_state)),
        env_states=to_port(jrunner.env_states), obs=None, generator=torch.Generator(),
        update_idx=0, seed=0)


def _dims(env):
    l_obs, n = env.config.flattened_obs_length, env.n_agents
    return BlockDims(l_obs, 128, 128, 5), CriticDims(n, l_obs, 128, 128)


def _jax_starts(jcfg, jrunner):
    """The (P,) window starts the JAX update draws from ``jrunner.key``
    (``mappo.py:581``; both update paths share them)."""
    k_perm = jax.random.split(jrunner.key, 3)[1]
    starts = jax_native.phase_window_starts(
        jcfg, T_LEN, jax_time_block(T_LEN // MINIBATCHES), k_perm)
    return torch.from_numpy(np.array(starts)).to(torch.int64)


def _chained_pair(env_id, phase):
    """N_UPDATES updates of each learner, each carrying its own runner (env
    states, observations, both parts' parameters and optimizer state, update
    index) from one update to the next; only the window starts go from JAX to
    the port."""
    jenv, env = make_pair(rware_tpu.make(env_id, max_steps=MAX_STEPS).config)
    jcfg, cfg = _configs()
    jrunner, actor, critic, tx = jax_mappo.init_mappo_runner(jenv, jcfg, jax.random.key(1))
    ts = compile_bf16_exact(
        jax_mappo.build_mappo_train_step(jenv, actor, critic, tx, jcfg, interpret=True,
                                         deterministic_collect=True, fused_critic_update=True,
                                         fused_critic_phase=phase), jrunner)
    runner = _port_runner(jrunner)
    dims, cdims = _dims(env)
    step = mappo.build_mappo_train_step(env, dims, cdims, cfg, deterministic_collect=True,
                                        fused_critic_phase=phase)
    first = runner
    history = []
    for _ in range(N_UPDATES):
        starts = _jax_starts(jcfg, jrunner)
        jrunner, jmetrics = ts(jrunner)
        runner, metrics = step(runner, starts)
        history.append((jrunner, jmetrics, runner, metrics))
    return cfg, history, first, step, phase


@pytest.fixture(scope="module", params=[False, True], ids=["per-pass", "whole-phase"])
def chained_pair(request):
    return _chained_pair("rware-tiny-2ag-v2", request.param)


def test_chained_updates_cross_episode_ends(chained_pair):
    _, history, _, _, _ = chained_pair
    done = [int(h[3]["episodes_done"]) for h in history]
    assert done == [int(h[1]["episodes_done"]) for h in history]
    assert done[0] == 0 and min(done[1:]) == ENV_BLOCK, done


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_chained_update_matches_jax(chained_pair, u):
    """After each update (u = 0 is the single update): env states and
    observations equal, both parts' parameters to ``atol = 0.05 * lr * P``,
    ``rtol = 1e-3``, optimizer counts and update index equal, metrics within
    rtol 1e-2 (and 1e-4: pg_loss is a mean of order-one terms that cancel to
    a few 1e-3, and a flipped bf16 rounding in a critic value moves single
    advantages by 1e-3)."""
    cfg, history, _, _, _ = chained_pair
    jrunner, jmetrics, runner, metrics = history[u]
    assert_fields_equal(runner.env_states, jrunner.env_states, ALL_FIELDS)
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
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-2, atol=1e-4,
                                   err_msg=k)


def test_update_moved_both_parts_and_runner_is_new(chained_pair):
    _, history, first, step, phase = chained_pair
    new = history[0][2]
    for part in PARTS:
        assert float((new.params[part] - first.params[part]).abs().max()) > 0
        assert first.opt_state[part].count == 0  # the input is untouched
    assert first.update_idx == 0
    # the actor's local value head is not trained: it stays at its init
    dims = step.dims
    head_new, head_old = dims.split(new.params["actor"])[4], dims.split(first.params["actor"])[4]
    assert torch.equal(head_new[:, dims.n_actions], head_old[:, dims.n_actions])
    assert not torch.equal(head_new[:, :dims.n_actions], head_old[:, :dims.n_actions])
    # CPU: every wrapper ran its plain version
    assert step.collect.launches == step.critic_values.launches == step.grads.launches == 0
    assert (step.update_phase is not None) == phase
    if phase:
        assert step.update_phase.launches == 0


@pytest.fixture(scope="module")
def first_update():
    """The pieces of one update before its update phase: the trajectory, the
    critic's values over it (K6), the bootstrap value and the advantages, of
    both packages."""
    jenv, env = make_pair("rware-tiny-2ag-v2")
    jcfg, cfg = _configs()
    jrunner, actor, critic, _ = jax_mappo.init_mappo_runner(jenv, jcfg, jax.random.key(0))
    # biases off zero, as training moves them: the two critic roundings differ
    rng = np.random.default_rng(0)
    cparams = jax.tree.map(
        lambda x: np.asarray(x) + 0.02 * rng.standard_normal(x.shape).astype(np.float32),
        jrunner.params["critic"])
    jrunner = jrunner.replace(params={"actor": jrunner.params["actor"], "critic": cparams})
    collect = build_pallas_collect(jenv.config, T_LEN, interpret=True, deterministic=True,
                                   tc_len=T_LEN)
    jstates, jtraj = jit_bf16_exact(lambda s, p: collect(s, p, 0), jrunner.env_states,
                                    jrunner.params["actor"])
    n, l_obs = env.n_agents, env.config.flattened_obs_length
    rb = ENV_BLOCK // LANE
    native_obs = jnp.asarray(jtraj["obs"]).reshape(T_LEN, rb, LANE, n, l_obs).transpose(
        0, 4, 3, 1, 2)
    vfn = jax_values(obs_len=l_obs, n_agents=n, rollout_len=T_LEN, mb_rows=rb, interpret=True)
    jvalues = np.asarray(jit_bf16_exact(vfn, cparams, native_obs))  # (T, N, RB, LANE)
    jvalues = jvalues.reshape(T_LEN, n, ENV_BLOCK).transpose(0, 2, 1)
    obs = jax.vmap(jax_ippo.policy_obs_fn(jenv))(jstates)
    jlast = jit_bf16_exact(critic.apply, cparams, obs.reshape(ENV_BLOCK, n * l_obs))
    jadv, _ = jax_ippo.compute_gae(jcfg, jtraj["reward"], jvalues, jtraj["done"], jlast)

    runner = _port_runner(jrunner)
    dims, cdims = _dims(env)
    step = mappo.build_mappo_train_step(env, dims, cdims, cfg, deterministic_collect=True)
    states, traj = step.rollout(runner)
    values = step.values(runner, traj)
    _, adv, _ = step.advantages(runner, states, traj, values)
    obs_t = env._obs_fn(states)
    return dict(jtraj=jtraj, jvalues=jvalues, jlast=np.asarray(jlast), jadv=np.asarray(jadv),
                traj=traj, values=values, adv=adv,
                last=mappo.critic_last_values(cdims, runner.params["critic"], obs_t),
                train_last=step.critic_values(runner.params["critic"],
                                           obs_t[None].to(torch.bfloat16).contiguous())[0])


def test_trajectory_equals_jax(first_update):
    traj, jtraj = first_update["traj"], first_update["jtraj"]
    np.testing.assert_array_equal(traj["obs"].float().numpy(),
                                  np.asarray(jtraj["obs"], dtype=np.float32))
    for k in ("action", "reward"):
        np.testing.assert_array_equal(traj[k].numpy(), np.asarray(jtraj[k]), err_msg=k)
    np.testing.assert_array_equal(traj["done"].numpy(), np.asarray(jtraj["done"]).astype(bool))


def test_critic_values_and_bootstrap_match_jax(first_update):
    """K6's values within 1e-5 on at least 98% of the envs and within a
    flipped bf16 rounding (2e-3) everywhere; the bootstrap value follows
    flax's ``critic.apply`` (within 1e-5 on 98% of the envs), which the
    kernels' rounding does not."""
    vdiff = np.abs(first_update["values"].numpy() - first_update["jvalues"])
    assert (vdiff.max(axis=(0, 2)) < 1e-5).mean() > 0.98 and vdiff.max() < 2e-3
    ldiff = np.abs(first_update["last"].numpy() - first_update["jlast"]).max(axis=1)
    assert (ldiff < 1e-5).mean() > 0.98 and ldiff.max() < 2e-3
    other = np.abs(first_update["train_last"].numpy() - first_update["jlast"]).max(axis=1)
    assert (other < 1e-5).mean() < 0.9  # the training forward is not the bootstrap's


def test_advantages_match_jax(first_update):
    """Advantages within 1e-5 in every env whose stored and last values
    agree with JAX's to 1e-6, and within 2e-3 everywhere."""
    vdiff = np.abs(first_update["values"].numpy() - first_update["jvalues"])
    ldiff = np.abs(first_update["last"].numpy() - first_update["jlast"])
    agree = (vdiff.max(axis=(0, 2)) < 1e-6) & (ldiff.max(axis=1) < 1e-6)
    assert agree.mean() > 0.9, agree.mean()
    adiff = np.abs(first_update["adv"].numpy() - first_update["jadv"])
    assert adiff[:, agree].max() < 1e-5
    assert adiff.max() < 2e-3


def test_old_value_is_the_critics_not_the_actors(first_update):
    """The dataset's values come from K6, not from the collector's local
    value head."""
    diff = (first_update["values"] - first_update["traj"]["value"]).abs()
    assert float(diff.mean()) > 1e-3


@pytest.mark.parametrize("phase", [False, True], ids=["per-pass", "whole-phase"])
def test_train_mappo_and_evaluate_entry_points(tmp_path, phase):
    out = train.main(["--algo", "mappo", "--device", "cpu", "--n-envs", "128",
                      "--rollout-len", "8", "--updates", "2", "--log-every", "1",
                      "--checkpoint-dir", str(tmp_path)] + ["--fused-critic-phase"] * phase)
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl", "reward_per_env",
              "episodes_done", "env_steps_per_s"):
        assert np.isfinite(out[k]), k
    path = str(tmp_path / "policy.pt")
    env_id, policy = train.load_policy(path)
    assert env_id == "rware-tiny-2ag-v2"
    saved = torch.load(path, map_location="cpu")["critic"]
    critic = CentralCritic(saved["joint_dim"], saved["n_agents"], tuple(saved["hidden"]))
    critic.load_state_dict(saved["state_dict"])
    assert critic.n_agents == 2
    fresh = mappo.init_mappo_runner(rware_tpu_torch.make(env_id, device="cpu"),
                                    ippo.IPPOConfig(n_envs=1), 0)[0]
    assert not torch.equal(CriticDims.of(critic).split(fresh.params["critic"])[0].t(),
                           critic.dense[0].weight)  # trained away from the init
    stats = evaluate.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path),
                           "--episodes", "8", "--max-steps", "40"])
    assert stats["episodes"] == 8 and np.isfinite(stats["mean_return"])


def test_mappo_entry_point_refuses_what_is_not_there():
    for argv in (["--algo", "mappo", "--net", "gru", "--collect", "plain"],
                 ["--algo", "mappo", "--collect", "plain", "--fused-critic-phase"],
                 ["--fused-critic-phase"]):
        with pytest.raises(NotImplementedError, match="no such learner"):
            train.main(argv + ["--device", "cpu"])
    # JAX's XLA-collect learner (tests/test_torch_mappo_plain.py holds it to JAX)
    out = train.main(["--algo", "mappo", "--collect", "plain", "--device", "cpu", "--n-envs",
                      "16", "--rollout-len", "4", "--updates", "1"])
    assert np.isfinite(out["v_loss"]) and np.isfinite(out["pg_loss"])
    with pytest.raises(ValueError, match="MLP policies only"):
        train.main(["--algo", "seac", "--net", "gru", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--algo", "mappo", "--updates", "1"])
