"""The recurrent slice as a whole, on the CPU: updates of the port's fused
recurrent learner against the JAX package's
``build_rnn_pallas_train_step(interpret=True, deterministic_collect=True)``
with the Pallas GRU sequence kernels selected (``GRU_SEQ_IMPL =
"pallas_interpret"``), from the same env states, parameters (biases made
nonzero), optimizer state and carry, with JAX's own epoch offsets handed
over; three chained updates across episode ends; the plain learner; and the
``train --net gru`` / ``evaluate`` entry points.

Tolerances.  Parameters within 0.05 * lr * P after P Adam steps (the bound of
the whole-update-phase kernel's tests: Adam normalises the gradient, so a
step is at most about lr, and the two sides' gradients differ by bf16
rounding flips, a percent of a step); metrics within rtol 1e-2.  Episode
counts and rewards exact in all envs whose deterministic actions agree (at
least 98% of them: see ``tests/test_torch_gru_collect.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.models import IPPOConfig as JaxConfig
from rware_tpu.models import ippo_rnn as jax_rnn
from rware_tpu.models.networks import RecurrentActorCritic as FlaxRecurrent
from rware_tpu.ops.pallas_rollout import ENV_BLOCK, LANE
from rware_tpu_torch import evaluate, train
from rware_tpu_torch.convert import (
    adam_state_from_optax,
    gru_params_from_flax,
    gru_params_to_flax,
)
from rware_tpu_torch.models import ippo, ippo_rnn
from rware_tpu_torch.models.networks import GruDims, RecurrentActorCritic
from tests.torch_ref import compile_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

T_LEN, EPOCHS, MINIBATCHES, EMBED, HG = 8, 2, 2, 32, 32
# episodes of MAX_STEPS end inside the 2nd and 3rd updates
N_UPDATES, MAX_STEPS = 3, 12


def jax_offsets(jrunner, rb):
    """The E row offsets the JAX update draws from its runner's key
    (``ippo_rnn.py:810, 870, 914``)."""
    k_perm = jax.random.split(jrunner.key, 2)[1]
    return [int(jax.random.randint(k, (), 0, rb)) for k in jax.random.split(k_perm, EPOCHS)]


@pytest.fixture(scope="module")
def chained_pair():
    """N_UPDATES updates of each learner, each carrying its own runner (env
    states, carry, parameters, optimizer state, update index); only the
    epoch offsets go from JAX to the port."""
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", max_steps=MAX_STEPS).config)
    jcfg = JaxConfig(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS,
                     minibatches=MINIBATCHES)
    model = FlaxRecurrent(n_actions=5, hidden=HG, embed=EMBED)
    jrunner, model, tx = jax_rnn.init_rnn_runner(jenv, jcfg, jax.random.key(1), model)
    rng = np.random.default_rng(5)
    biased = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.2 * rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "bias" else x, jrunner.params)
    jrunner = jrunner.replace(params=biased, opt_state=tx.init(biased))
    dims = GruDims(env.config.flattened_obs_length, EMBED, HG, 5)
    cfg = ippo.IPPOConfig(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS,
                          minibatches=MINIBATCHES)
    runner = ippo_rnn.RNNRunnerState(
        params=gru_params_from_flax(jax.tree.map(np.asarray, jrunner.params)),
        opt_state=adam_state_from_optax(jax.tree.map(np.asarray, jrunner.opt_state),
                                        from_flax=gru_params_from_flax),
        env_states=to_port(jrunner.env_states), obs=None,
        carry=torch.zeros((ENV_BLOCK, 2, HG), dtype=torch.bfloat16),
        generator=torch.Generator(), update_idx=0, seed=0)
    step = ippo_rnn.build_rnn_fused_train_step(env, dims, cfg, deterministic_collect=True)
    history = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rnn, "GRU_SEQ_IMPL", "pallas_interpret")
        ts = compile_bf16_exact(
            jax_rnn.build_rnn_pallas_train_step(jenv, model, tx, jcfg, interpret=True,
                                                deterministic_collect=True), jrunner)
        for _ in range(N_UPDATES):
            offsets = jax_offsets(jrunner, ENV_BLOCK // LANE)
            jrunner, jmetrics = ts(jrunner)
            runner, metrics = step(runner, torch.tensor(offsets))
            history.append((jrunner, jmetrics, runner, metrics, offsets))
    return cfg, dims, history, step


def test_chained_updates_cross_episode_ends(chained_pair):
    _, _, history, _ = chained_pair
    done = [int(h[3]["episodes_done"]) for h in history]
    assert done == [int(h[1]["episodes_done"]) for h in history]
    assert done[0] == 0 and min(done[1:]) == ENV_BLOCK, done
    assert len({tuple(h[4]) for h in history}) > 1  # the offsets vary between updates


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_chained_update_matches_jax(chained_pair, u):
    """After each update: parameters within 0.05 * lr * P, optimizer count
    and update index equal, metrics within rtol 1e-2, the carry within 5e-2
    and the env states equal in the envs whose actions agreed so far."""
    cfg, dims, history, _ = chained_pair
    jrunner, jmetrics, runner, metrics, _ = history[u]
    p = cfg.epochs * cfg.minibatches
    want = gru_params_from_flax(jax.tree.map(np.asarray, jrunner.params))
    np.testing.assert_allclose(runner.params.numpy(), want.numpy(), atol=0.05 * cfg.lr * p,
                               rtol=1e-3)
    assert runner.opt_state.count == int(jrunner.opt_state[1][0].count) == p * (u + 1)
    assert runner.update_idx == int(jrunner.update_idx) == u + 1
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-2, atol=1e-6, err_msg=k)
    same = np.all(runner.env_states.agent_x.numpy() == np.asarray(jrunner.env_states.agent_x), 1) \
        & np.all(runner.env_states.agent_y.numpy() == np.asarray(jrunner.env_states.agent_y), 1)
    assert same.mean() >= 0.95, same.mean()
    carry = runner.carry.float().numpy()
    jcarry = np.asarray(jrunner.carry.astype(jnp.float32))
    assert runner.carry.dtype == torch.bfloat16 and carry.shape == jcarry.shape
    np.testing.assert_allclose(carry[same], jcarry[same], atol=5e-2)


def test_update_moved_every_block_and_runner_is_new(chained_pair):
    cfg, dims, history, step = chained_pair
    first, last = history[0][2], history[-1][2]
    for k, (a, b) in enumerate(zip(dims.split(first.params), dims.split(last.params))):
        assert float((a - b).abs().max()) > 0, f"block {k} did not move"
    assert step.collect.launches == step.gru_fwd.launches == step.gru_bwd.launches == 0  # CPU
    back = gru_params_to_flax(last.params, dims)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), atol=1e-2),
                 back, jax.tree.map(np.asarray, history[-1][0].params))


def test_band_arithmetic_is_jax():
    """Pass i of an epoch takes rows (i * mb - off) % rb onwards, rows of 128
    envs (``ippo_rnn.py:849-878``)."""
    cfg = ippo.IPPOConfig(n_envs=4096, minibatches=4)
    assert ippo_rnn.band_rows(cfg) == (128, 32)
    n_env, starts = ippo_rnn.epoch_band_starts(cfg, 5)
    assert n_env == 1024 and starts == [27 * 128, 3 * 128, 11 * 128, 19 * 128]
    assert ippo_rnn.epoch_band_starts(cfg, 0)[1] == [0, 1024, 2048, 3072]
    x = torch.arange(4096)[None, :]
    band = ippo_rnn.band_slice(x, 27 * 128, 1024)[0]
    assert band[0] == 27 * 128 and band[-1] == 3 * 128 - 1 and band.numel() == 1024
    assert ippo_rnn.band_rows(ippo.IPPOConfig(n_envs=128, minibatches=4)) == (32, 4)
    with pytest.raises(ValueError, match="must divide"):
        ippo_rnn.band_rows(ippo.IPPOConfig(n_envs=1000, minibatches=4))


def test_plain_learner_runs_and_learns_something():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu", max_steps=6)
    cfg = ippo.IPPOConfig(n_envs=16, rollout_len=8, epochs=2, minibatches=2)
    runner, dims = ippo_rnn.init_rnn_runner(env, cfg, seed=0, hidden=16, embed=16)
    step = ippo_rnn.build_rnn_train_step(env, dims, cfg)
    new, metrics = step(runner)
    new2, _ = step(new)
    assert float((new.params - runner.params).abs().max()) > 0
    assert new2.update_idx == 2 and new2.opt_state.count == 8
    assert int(metrics["episodes_done"]) == 16  # episodes of 6 steps end inside the rollout
    assert new.carry.dtype == torch.bfloat16 and new.carry.shape == (16, 2, 16)
    assert not torch.equal(new.carry, runner.carry)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k


def test_train_and_evaluate_entry_points_gru(tmp_path):
    out = train.main(["--net", "gru", "--device", "cpu", "--n-envs", "128", "--rollout-len", "8",
                      "--updates", "2", "--log-every", "1", "--checkpoint-dir", str(tmp_path)])
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl", "reward_per_env",
              "episodes_done", "env_steps_per_s"):
        assert np.isfinite(out[k]), k
    env_id, policy = train.load_policy(str(tmp_path / "policy.pt"))
    assert env_id == "rware-tiny-2ag-v2" and isinstance(policy, RecurrentActorCritic)
    assert torch.load(str(tmp_path / "policy.pt"))["net"] == "gru"
    stats = evaluate.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path),
                           "--episodes", "8", "--max-steps", "40"])
    assert stats["episodes"] == 8 and np.isfinite(stats["mean_return"])
    assert stats["mean_length"] <= 40


def test_plain_collect_entry_point_and_mlp_checkpoint_kind(tmp_path):
    train.main(["--net", "gru", "--collect", "plain", "--device", "cpu", "--n-envs", "16",
                "--rollout-len", "4", "--updates", "1", "--checkpoint-dir", str(tmp_path / "g")])
    assert isinstance(train.load_policy(str(tmp_path / "g" / "policy.pt"))[1],
                      RecurrentActorCritic)
    train.main(["--device", "cpu", "--n-envs", "16", "--rollout-len", "4", "--updates", "1",
                "--checkpoint-dir", str(tmp_path / "m")])
    ckpt = torch.load(str(tmp_path / "m" / "policy.pt"))
    assert ckpt["net"] == "mlp"
    assert not isinstance(train.load_policy(str(tmp_path / "m" / "policy.pt"))[1],
                          RecurrentActorCritic)
    ckpt["net"] = "transformer"
    torch.save(ckpt, str(tmp_path / "m" / "policy.pt"))
    with pytest.raises(ValueError, match="unknown net kind"):
        train.load_policy(str(tmp_path / "m" / "policy.pt"))
