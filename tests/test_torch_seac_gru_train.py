"""Recurrent SEAC-PPO as a whole, on the CPU: three chained updates of the
port's learner (the per-agent recurrent collector K2d′, the cross replay for
the old values and the bootstrap, cross GAE, then E x M env-band passes of
the cross-replay loss by autograd) against the JAX package's
``build_seac_gru_train_step(collect_mode="pallas", interpret=True,
deterministic_collect=True)``, without and with two message bits, from the
same env states, parameters (biases made nonzero), optimizer state and zero
carry, with JAX's own epoch offsets handed over; and ``train --algo seac-ppo
--net gru``.

Two port runners follow the JAX one, as ``tests/test_torch_msg_mappo_train.py``
runs MAPPO's: the resynced runner's parameters and optimizer state are set to
JAX's before each update, so each update is compared alone at ``0.05 * lr *
P`` after P Adam steps (the bound of the other learners' chained tests); the
carried runner keeps its own.  Carried, the sides part by more than that
after the first update with message bits: the two sides' gradients agree to
about 0.5% of each block's largest (``tests/test_torch_seac_gru.py``), and
where a gradient sits near Adam's eps (1e-5) such a difference moves a step
by a good part of lr.  So after the first update the carried runner is held
to twice the distance between JAX's run and JAX's own run continued from the
port's parameters and optimizer state after the first update: the chain may
carry the first update's gap on as JAX's dynamics carry it, and no further.
(A JAX run whose initial weights moved by one part in 2**23, PR 6's witness
for MAPPO, parts from JAX by less than the summation-order noise of one
update does: 2.3e-5 against 1.0e-4 at M=2; ``-s`` prints both readings.)

Other tolerances, as ``tests/test_torch_msg_rnn_train.py`` holds recurrent
IPPO: metrics within rtol 1e-2 (``approx_kl`` within 2e-3: under the kernel's
collect the first epoch's own-stream ratio is only about 1, because the
collector and the replay round the cell differently, ``seac.py:1096-1100``),
episode counts exact, env states equal in the envs whose deterministic actions
and bits agreed (at least 95%) and the carry within 5e-2 there.
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
from rware_tpu.models.networks import RecurrentActorCritic as FlaxRecurrent
from rware_tpu.ops.pallas_rollout import ENV_BLOCK
from rware_tpu_torch import evaluate, train
from rware_tpu_torch.convert import (
    seac_opt_state_from_optax,
    seac_opt_state_to_optax,
    seac_params_from_flax,
    seac_params_to_flax,
)
from rware_tpu_torch.models import ippo, seac
from rware_tpu_torch.models.ippo_rnn import RNNRunnerState
from rware_tpu_torch.models.networks import GruDims
from tests.test_torch_msg_mappo_train import _one_ulp
from tests.torch_ref import compile_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

T_LEN, EPOCHS, MINIBATCHES, HG = 8, 2, 2, 32
N_UPDATES, MAX_STEPS = 3, 12  # episodes end inside the 2nd and 3rd updates


def jax_offsets(jrunner):
    """The E env offsets JAX's recurrent update draws from its runner's key
    (``seac.py:1031, 1110``)."""
    k_perm = jax.random.split(jrunner.key, 3)[2]
    return [int(jax.random.randint(k, (), 0, ENV_BLOCK))
            for k in jax.random.split(k_perm, EPOCHS)]


def run_pair(msg_bits):
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", max_steps=MAX_STEPS,
                                         msg_bits=msg_bits).config)
    jcfg = jax_seac.SEACPPOConfig(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS,
                                  minibatches=MINIBATCHES)
    model = FlaxRecurrent(n_actions=5, hidden=HG, embed=HG, msg_bits=msg_bits)
    jrunner, model, tx = jax_seac.init_seac_gru(jenv, jcfg, jax.random.key(1), model)
    rng = np.random.default_rng(5)
    biased = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.2 * rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "bias" else x, jrunner.params)
    jrunner = jrunner.replace(params=biased, opt_state=tx.init(biased))
    cfg = seac.SEACPPOConfig(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS,
                             minibatches=MINIBATCHES)
    dims = GruDims(env.config.flattened_obs_length, HG, HG, 5, msg_bits)
    runner = carried = port_runner(jrunner)
    step = seac.build_seac_gru_train_step(env, dims, cfg, deterministic_collect=True)
    ts = compile_bf16_exact(
        jax_seac.build_seac_gru_train_step(jenv, model, tx, jcfg, collect_mode="pallas",
                                           interpret=True, deterministic_collect=True), jrunner)
    jmoved = jrunner.replace(params=_one_ulp(jrunner.params, 5))
    jfrom, history = None, []
    for u in range(N_UPDATES):
        offsets = jax_offsets(jrunner)
        synced = port_runner(jrunner)
        runner = dataclasses.replace(runner, params=synced.params, opt_state=synced.opt_state)
        if u == 1:  # JAX from the carried port runner's parameters and moments
            jfrom = jrunner.replace(
                params=jax.tree.map(jnp.asarray, seac_params_to_flax(carried.params, dims)),
                opt_state=jax.tree.map(jnp.asarray, seac_opt_state_to_optax(
                    carried.opt_state, dims, jax.tree.map(np.asarray, jrunner.opt_state))))
        jrunner, jmetrics = ts(jrunner)
        jmoved, _ = ts(jmoved)
        if jfrom is not None:
            jfrom, _ = ts(jfrom)
        runner, metrics = step(runner, offsets)
        carried, _ = step(carried, offsets)
        history.append((jrunner, jmetrics, runner, metrics, offsets, carried, jmoved, jfrom))
    return cfg, dims, history, step


def port_runner(jrunner):
    """The port's runner of a JAX ``SEACGRURunner`` (seed 0, update 0)."""
    return RNNRunnerState(
        params=seac_params_from_flax(jax.tree.map(np.asarray, jrunner.params)),
        opt_state=seac_opt_state_from_optax(jax.tree.map(np.asarray, jrunner.opt_state)),
        env_states=to_port(jrunner.env_states), obs=None,
        carry=torch.from_numpy(np.array(jrunner.carry.astype(jnp.float32))).to(torch.bfloat16),
        generator=torch.Generator(), update_idx=int(jrunner.update_idx), seed=0)


@pytest.fixture(scope="module", params=[0, 2], ids=lambda m: f"M{m}")
def chained_pair(request):
    return run_pair(request.param)


def test_chained_updates_cross_episode_ends(chained_pair):
    _, _, history, step = chained_pair
    done = [int(h[3]["episodes_done"]) for h in history]
    assert done == [int(h[1]["episodes_done"]) for h in history]
    assert done[0] == 0 and min(done[1:]) == ENV_BLOCK, done
    assert len({tuple(h[4]) for h in history}) > 1  # the offsets vary between updates
    assert step.collect.launches == 0 and not step.remat  # CPU: the plain version


def same_envs(runner, jrunner):
    """(B,) the envs whose agents' positions and messages agree."""
    st, jst = runner.env_states, jrunner.env_states
    return np.all(st.agent_x.numpy() == np.asarray(jst.agent_x), 1) \
        & np.all(st.agent_y.numpy() == np.asarray(jst.agent_y), 1) \
        & np.all(st.agent_message.numpy() == np.asarray(jst.agent_message), (1, 2))


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_resynced_update_matches_jax(chained_pair, u):
    """From JAX's parameters, after each update: every agent's parameters
    within 0.05 * lr * P, optimizer count and update index equal, metrics
    within rtol 1e-2, the env states and the carry equal in the envs whose
    actions agreed."""
    cfg, dims, history, _ = chained_pair
    jrunner, jmetrics, runner, metrics = history[u][:4]
    p = cfg.epochs * cfg.minibatches
    want = seac_params_from_flax(jax.tree.map(np.asarray, jrunner.params))
    assert runner.params.shape == want.shape == (2, dims.n_params)
    np.testing.assert_allclose(runner.params.numpy(), want.numpy(), atol=0.05 * cfg.lr * p,
                               rtol=1e-3)
    assert runner.opt_state.count == int(jrunner.opt_state[1][0].count) == p * (u + 1)
    assert runner.update_idx == int(jrunner.update_idx) == u + 1
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-2,
                                   atol=2e-3 if k == "approx_kl" else 1e-4, err_msg=k)
    same = same_envs(runner, jrunner)
    assert same.mean() >= 0.95, same.mean()
    np.testing.assert_allclose(runner.carry.float().numpy()[same],
                               np.asarray(jrunner.carry.astype(jnp.float32))[same], atol=5e-2)


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_carried_update_tracks_jax(chained_pair, u):
    """Each side carrying its own parameters and optimizer state: the first
    update's parameters within 0.05 * lr * P; after each later one, the
    largest difference from JAX within twice that of JAX's own run from the
    port's state after the first update; every block learns."""
    cfg, dims, history, _ = chained_pair
    jrunner, carried, jmoved, jfrom = (history[u][k] for k in (0, 5, 6, 7))
    assert carried.opt_state.count == cfg.epochs * cfg.minibatches * (u + 1)
    assert same_envs(carried, jrunner).mean() >= 0.95

    def flat(r):
        return seac_params_from_flax(jax.tree.map(np.asarray, r.params))

    want = flat(jrunner)
    drift = float((carried.params - want).abs().max())
    readings = f"|port - JAX| {drift:.4g}, |JAX one ulp - JAX| " \
               f"{float((flat(jmoved) - want).abs().max()):.4g}"
    if u == 0:
        print(f"M={dims.msg_bits} update 1: {readings}")
        np.testing.assert_allclose(carried.params.numpy(), want.numpy(),
                                   atol=0.05 * cfg.lr * cfg.epochs * cfg.minibatches, rtol=1e-3)
    else:
        spread = float((flat(jfrom) - want).abs().max())
        print(f"M={dims.msg_bits} update {u + 1}: {readings}, |JAX from the port - JAX| "
              f"{spread:.4g}")
        assert 0 < drift <= 2 * spread, (drift, spread)
        for block in dims.split(carried.params[1] - history[0][5].params[1]):
            assert float(block.abs().max()) > 0  # every block learns


def test_train_and_evaluate_entry_points_seac_gru(tmp_path):
    for bits in ([], ["--msg-bits", "2"]):
        out_dir = tmp_path / f"m{len(bits)}"
        out = train.main(["--algo", "seac-ppo", "--net", "gru", "--device", "cpu", "--n-envs",
                          "16", "--rollout-len", "8", "--updates", "2", "--log-every", "1",
                          "--checkpoint-dir", str(out_dir)] + bits)
        for k in ("pg_loss", "v_loss", "entropy", "approx_kl", "reward_per_env"):
            assert np.isfinite(out[k]), k
        ckpt = torch.load(str(out_dir / "policy.pt"))
        assert ckpt["net"] == "gru" and ckpt["per_agent"] == 2
        assert ckpt["msg_bits"] == (2 if bits else 0)
        _, policies = train.load_policy(str(out_dir / "policy.pt"))
        assert isinstance(policies, torch.nn.ModuleList) and len(policies) == 2
        assert all(p.msg_bits == ckpt["msg_bits"] for p in policies)
        assert not torch.equal(policies[0].gru["ir"].weight, policies[1].gru["ir"].weight)
        stats = evaluate.main(["--device", "cpu", "--checkpoint-dir", str(out_dir),
                               "--episodes", "8", "--max-steps", "30"])
        assert stats["episodes"] == 8 and np.isfinite(stats["mean_return"])
    # JAX's XLA-collect learner (tests/test_torch_seac_gru_plain.py holds it to JAX)
    out = train.main(["--algo", "seac-ppo", "--net", "gru", "--collect", "plain", "--device",
                      "cpu", "--n-envs", "8", "--rollout-len", "4", "--updates", "1"])
    assert np.isfinite(out["v_loss"]) and np.isfinite(out["pg_loss"])


def test_learner_draws_its_own_offsets():
    """Without offsets the learner draws E env offsets in [0, B) from the
    runner's generator: two runners of one seed take the same update."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu", max_steps=5)
    cfg = seac.SEACPPOConfig(n_envs=16, rollout_len=8, epochs=2, minibatches=2)
    a, dims = seac.init_seac_gru(env, cfg, seed=1, hidden=16, embed=16)
    b, _ = seac.init_seac_gru(env, cfg, seed=1, hidden=16, embed=16)
    step = seac.build_seac_gru_train_step(env, dims, cfg)
    a, metrics = step(a)
    b, _ = step(b)
    assert torch.equal(a.params, b.params) and a.opt_state.count == 4
    assert torch.equal(a.carry, b.carry) and int(metrics["episodes_done"]) == 16
    assert set(metrics) == {"reward_per_env", "episodes_done", *ippo.METRIC_KEYS}
    with pytest.raises(ValueError, match="must divide"):
        seac.build_seac_gru_train_step(env, dims, seac.SEACPPOConfig(n_envs=10))
