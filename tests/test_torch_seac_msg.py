"""SEAC-PPO with message bits, on the CPU: the per-agent collector's message
mode (K2d with K2b) against ``build_pallas_collect(policy="mlp_per_agent",
interpret=True, deterministic=True)``; three chained updates of the port's
flat learner (K2d with K2b collect, cross values and GAE in flax's rounding,
flat minibatches over ``T * B`` rows by autograd) against the JAX package's
``build_seac_ppo_train_step(collect_mode="pallas", interpret=True,
deterministic_collect=True)``, whose ``update_mode="auto"`` picks that flat
update under message bits (``seac.py:343-345``); and ``train --algo seac-ppo
--msg-bits``.

Tolerances.  The collector as ``tests/test_torch_fused_seac.py`` holds K2d:
observations exact in every env whose actions and bits agreed so far,
rewards, ``done``, bits and the final state equal in the envs whose actions
and bits all agree, at least 99% of the actions equal, values and log-probs
within 2e-2.  The updates as ``tests/test_torch_seac_gru_train.py`` holds
recurrent SEAC's: a resynced runner (JAX's parameters and optimizer state
before each update) within 0.05 * lr * P after P Adam steps; a carried runner
within that after the first update and then within twice the distance
between JAX's run and JAX's own run continued from the port's state after
the first update; metrics within rtol 1e-2 (``approx_kl`` within 2e-3: the
kernel's collect rounds the network differently from flax, so the first
epoch's own ratio is only about 1); episode counts exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.models import seac as jax_seac
from rware_tpu.ops.pallas_rollout import ENV_BLOCK, build_pallas_collect
from rware_tpu_torch import convert, evaluate, train
from rware_tpu_torch.models import ippo, seac
from rware_tpu_torch.models.networks import BlockDims
from rware_tpu_torch.ops.fused_rollout import build_fused_collect_per_agent
from tests.test_torch_msg_mappo_train import _one_ulp
from tests.torch_ref import compile_bf16_exact, jax_states, jit_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

M = 2
T_LEN, EPOCHS, MINIBATCHES = 8, 2, 2
N_UPDATES, MAX_STEPS = 3, 40


def stacked_msg_params(seed, obs_len, bias_noise=0.1):
    """N = 2 independent flax inits with a message head, stacked on a
    leading agent axis (``init_seac``), biases moved off zero."""
    from rware_tpu.models import ActorCritic as FlaxActorCritic

    model = FlaxActorCritic(n_actions=5, msg_bits=M)
    params = jax.vmap(lambda k: model.init(k, jnp.zeros((1, obs_len))))(
        jax.random.split(jax.random.key(seed), 2))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + bias_noise * rng.standard_normal(x.shape).astype(
            np.float32) if path[-1].key == "bias" else np.asarray(x), params)


@pytest.fixture(scope="module")
def collect_pair():
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", max_steps=6, msg_bits=M).config)
    length = env.config.flattened_obs_length
    params = stacked_msg_params(3, length)
    jstates = jax_states(jenv, ENV_BLOCK, seed=2)
    jcollect = build_pallas_collect(jenv.config, 8, tc_len=4, interpret=True,
                                    deterministic=True, policy="mlp_per_agent")
    jns, jtraj = jit_bf16_exact(lambda s, p: jcollect(s, p, 0), jstates,
                                jax.tree.map(jnp.asarray, params))
    dims = BlockDims(length, 128, 128, 5, M)
    policies = seac.seac_policies_of(dims, convert.seac_params_from_flax(params))
    collect = build_fused_collect_per_agent(env.config, 8, deterministic=True)
    ns, traj = collect(to_port(jstates), policies, 0)
    same = (traj["action"].numpy() == np.asarray(jtraj["action"])) \
        & (traj["bits"].numpy() == np.asarray(jtraj["bits"])).all(-1)
    return dict(jns=jns, jtraj=jtraj, ns=ns, traj=traj, same=same, collect=collect)


def test_k2d_message_mode_matches_pallas(collect_pair):
    traj, jtraj, same = collect_pair["traj"], collect_pair["jtraj"], collect_pair["same"]
    assert collect_pair["collect"].launches == 0  # CPU tensors take the plain version
    assert same.mean() >= 0.99
    step_ok = same.all(-1)  # (T, B)
    lockstep = np.concatenate([np.ones_like(step_ok[:1]), np.cumprod(step_ok, 0)[:-1]], 0) > 0
    np.testing.assert_array_equal(traj["obs"].float().numpy()[lockstep],
                                  np.asarray(jtraj["obs"], dtype=np.float32)[lockstep])
    ok = same.all(axis=(0, 2))
    assert ok.mean() >= 0.98
    for k in ("reward", "done", "bits"):
        np.testing.assert_array_equal(traj[k].numpy()[:, ok],
                                      np.asarray(jtraj[k]).astype(traj[k].numpy().dtype)[:, ok],
                                      err_msg=k)
    for k in ("value", "logp"):
        np.testing.assert_allclose(traj[k].numpy()[:, ok], np.asarray(jtraj[k])[:, ok], atol=2e-2,
                                   err_msg=k)
    got = convert.state_to_numpy(collect_pair["ns"])
    for f in ("agent_x", "agent_y", "agent_dir", "agent_carrying", "agent_message",
              "request_queue", "cur_steps"):
        np.testing.assert_array_equal(got[f][ok], np.asarray(getattr(collect_pair["jns"], f))[ok],
                                      err_msg=f)
    assert int(traj["done"].sum()) == ENV_BLOCK
    share = float(traj["bits"].float().mean())
    assert 0.05 < share < 0.95, share
    # the agents run different networks: their deterministic bits differ
    b = traj["bits"].numpy()
    assert (b[:, :, 0] != b[:, :, 1]).mean() > 0.05


def jax_offsets(jrunner):
    """The E row offsets JAX's flat update draws from its runner's key
    (``seac.py:609, 700``)."""
    k_perm = jax.random.split(jrunner.key, 3)[2]
    return [int(jax.random.randint(k, (), 0, T_LEN * ENV_BLOCK))
            for k in jax.random.split(k_perm, EPOCHS)]


def port_runner(jrunner):
    """The port's runner of a JAX ``SEACRunner`` (seed 0)."""
    return ippo.RunnerState(
        params=convert.seac_params_from_flax(jax.tree.map(np.asarray, jrunner.params)),
        opt_state=convert.seac_opt_state_from_optax(jax.tree.map(np.asarray, jrunner.opt_state)),
        env_states=to_port(jrunner.env_states), obs=None, generator=torch.Generator(),
        update_idx=int(jrunner.update_idx), seed=0)


@pytest.fixture(scope="module")
def chained_pair():
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", max_steps=MAX_STEPS,
                                         msg_bits=M).config)
    jcfg = jax_seac.SEACPPOConfig(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS,
                                  minibatches=MINIBATCHES)
    jrunner, model, tx = jax_seac.init_seac_ppo(jenv, jcfg, jax.random.key(1))
    assert model.msg_bits == M
    rng = np.random.default_rng(5)
    biased = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.2 * rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "bias" else x, jrunner.params)
    # staggered episode ends: deterministic mode respawns every env that ends
    # at one step into the same state, and envs ending together would repeat
    # each later sample, so that one flipped bf16 rounding moves a
    # minibatch's gradient coherently (tests/test_torch_msg_mappo_train.py)
    steps = np.random.default_rng(0).integers(0, MAX_STEPS, ENV_BLOCK).astype(np.int32)
    jrunner = jrunner.replace(params=biased, opt_state=tx.init(biased),
                              env_states=jrunner.env_states.replace(cur_steps=jnp.asarray(steps)))
    cfg = seac.SEACPPOConfig(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS,
                             minibatches=MINIBATCHES)
    dims = BlockDims(env.config.flattened_obs_length, 128, 128, 5, M)
    step = seac.build_seac_ppo_train_step(env, dims, cfg, deterministic_collect=True)
    ts = compile_bf16_exact(
        jax_seac.build_seac_ppo_train_step(jenv, model, tx, jcfg, collect_mode="pallas",
                                           interpret=True, deterministic_collect=True), jrunner)
    jmoved = jrunner.replace(params=_one_ulp(jrunner.params, 5))
    runner = carried = port_runner(jrunner)
    jfrom, history = None, []
    for u in range(N_UPDATES):
        offsets = jax_offsets(jrunner)
        synced = port_runner(jrunner)
        runner = dataclasses.replace(runner, params=synced.params, opt_state=synced.opt_state)
        if u == 1:  # JAX from the carried port runner's parameters and moments
            jfrom = jrunner.replace(
                params=jax.tree.map(jnp.asarray, convert.seac_params_to_flax(carried.params, dims)),
                opt_state=jax.tree.map(jnp.asarray, convert.seac_opt_state_to_optax(
                    carried.opt_state, dims, jax.tree.map(np.asarray, jrunner.opt_state))))
        jrunner, jmetrics = ts(jrunner)
        jmoved, _ = ts(jmoved)
        if jfrom is not None:
            jfrom, _ = ts(jfrom)
        runner, metrics = step(runner, offsets)
        carried, _ = step(carried, offsets)
        history.append((jrunner, jmetrics, runner, metrics, offsets, carried, jmoved, jfrom))
    return cfg, dims, history, step


def flat(jrunner):
    return convert.seac_params_from_flax(jax.tree.map(np.asarray, jrunner.params))


def test_chained_updates_cross_episode_ends(chained_pair):
    _, _, history, step = chained_pair
    done = [int(h[3]["episodes_done"]) for h in history]
    assert done == [int(h[1]["episodes_done"]) for h in history]
    assert min(done) > 150, done  # episodes end in every update
    assert len({tuple(h[4]) for h in history}) > 1  # the offsets vary between updates
    assert step.collect.launches == 0 and not step.plain_collect  # CPU: the plain version


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_resynced_update_matches_jax(chained_pair, u):
    cfg, dims, history, _ = chained_pair
    jrunner, jmetrics, runner, metrics = history[u][:4]
    p = cfg.epochs * cfg.minibatches
    np.testing.assert_allclose(runner.params.numpy(), flat(jrunner).numpy(),
                               atol=0.05 * cfg.lr * p, rtol=1e-3)
    assert runner.opt_state.count == int(jrunner.opt_state[1][0].count) == p * (u + 1)
    assert runner.update_idx == int(jrunner.update_idx) == u + 1
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-2,
                                   atol=2e-3 if k == "approx_kl" else 1e-4, err_msg=k)
    st, jst = runner.env_states, jrunner.env_states
    same = np.all(st.agent_x.numpy() == np.asarray(jst.agent_x), 1) \
        & np.all(st.agent_message.numpy() == np.asarray(jst.agent_message), (1, 2))
    assert same.mean() >= 0.95, same.mean()


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_carried_update_tracks_jax(chained_pair, u):
    cfg, dims, history, _ = chained_pair
    jrunner, carried, jmoved, jfrom = (history[u][k] for k in (0, 5, 6, 7))
    want = flat(jrunner)
    drift = float((carried.params - want).abs().max())
    readings = f"|port - JAX| {drift:.4g}, |JAX one ulp - JAX| " \
               f"{float((flat(jmoved) - want).abs().max()):.4g}"
    if u == 0:
        print(f"SEAC-PPO M={M} update 1: {readings}")
        np.testing.assert_allclose(carried.params.numpy(), want.numpy(),
                                   atol=0.05 * cfg.lr * cfg.epochs * cfg.minibatches, rtol=1e-3)
    else:
        spread = float((flat(jfrom) - want).abs().max())
        print(f"SEAC-PPO M={M} update {u + 1}: {readings}, |JAX from the port - JAX| "
              f"{spread:.4g}")
        assert 0 < drift <= 2 * spread, (drift, spread)
    message = dims.split(carried.params[0] - history[0][5].params[0])[4][:, 6:]
    assert u == 0 or float(message.abs().max()) > 0  # the message head learns


def test_train_and_evaluate_entry_points_seac_msg(tmp_path):
    out = train.main(["--algo", "seac-ppo", "--msg-bits", "2", "--device", "cpu", "--n-envs",
                      "32", "--rollout-len", "8", "--updates", "2", "--log-every", "1",
                      "--checkpoint-dir", str(tmp_path)])
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl", "reward_per_env"):
        assert np.isfinite(out[k]), k
    assert out["entropy"] > np.log(5)  # the joint entropy: move and two bits
    ckpt = torch.load(str(tmp_path / "policy.pt"))
    assert ckpt["net"] == "mlp" and ckpt["per_agent"] == 2 and ckpt["msg_bits"] == 2
    _, policies = train.load_policy(str(tmp_path / "policy.pt"))
    assert all(p.msg_bits == 2 for p in policies)
    stats = evaluate.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path),
                           "--episodes", "8", "--max-steps", "30"])
    assert stats["episodes"] == 8 and np.isfinite(stats["mean_return"])
    train.main(["--algo", "seac-ppo", "--msg-bits", "1", "--collect", "plain", "--device", "cpu",
                "--n-envs", "16", "--rollout-len", "4", "--updates", "1"])
    # K8 has no message head: the time-window learner refuses message bits
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu", msg_bits=1)
    cfg = seac.SEACPPOConfig(n_envs=8, rollout_len=4)
    runner, dims = seac.init_seac_ppo(env, cfg, 0)
    with pytest.raises(NotImplementedError, match="no message head"):
        seac.build_seac_ppo_fused_train_step(env, dims, cfg)
