"""The SEAC-PPO slice as a whole, on the CPU: updates of the port's fused
learner against the JAX package's ``build_seac_ppo_train_step(
collect_mode="pallas", interpret=True, deterministic_collect=True,
update_mode="fused")`` from the same env states, parameters (biases made
nonzero) and optimizer state, with JAX's own epoch offsets handed over;
three chained updates across episode ends; the plain learner; and the
``train --algo seac-ppo`` / ``evaluate`` entry points.

Tolerances.  Parameters within 0.05 * lr * P after P Adam steps (the bound of
the other learners' chained tests: Adam normalises the gradient, so a step is
at most about lr, and the two sides' gradients differ by bf16 rounding
flips); metrics within rtol 1e-2, and pg_loss (a mean of normalised
advantages, near 0) within 1e-4 as MAPPO's chained test holds it.  Episode
counts exact; env states equal in the envs whose deterministic actions agree
(at least 95% of them: a near-tie of two logits flips an action now and
then).
"""
import jax
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.models import seac as jax_seac
from rware_tpu.ops.pallas_rollout import ENV_BLOCK
from rware_tpu_torch import evaluate, train
from rware_tpu_torch.convert import (
    seac_opt_state_from_optax,
    seac_params_from_flax,
    seac_params_to_flax,
)
from rware_tpu_torch.models import ippo, seac
from rware_tpu_torch.models.networks import BlockDims
from tests.torch_ref import compile_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

T_LEN, EPOCHS, MINIBATCHES = 8, 2, 2
# episodes of MAX_STEPS end inside the 2nd and 3rd updates
N_UPDATES, MAX_STEPS = 3, 12


def jax_offsets(jrunner):
    """The E time-row offsets JAX's fused update draws from its runner's key
    (``seac.py:504, 562-564, 583-587``)."""
    k_perm = jax.random.split(jrunner.key, 2)[1]
    return [int(jax.random.randint(k, (), 0, T_LEN)) for k in jax.random.split(k_perm, EPOCHS)]


@pytest.fixture(scope="module")
def chained_pair():
    """N_UPDATES updates of each learner, each carrying its own runner (env
    states, parameters, optimizer state, update index); only the epoch
    offsets go from JAX to the port."""
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", max_steps=MAX_STEPS).config)
    jcfg = jax_seac.SEACPPOConfig(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS,
                                  minibatches=MINIBATCHES)
    jrunner, model, tx = jax_seac.init_seac_ppo(jenv, jcfg, jax.random.key(1))
    rng = np.random.default_rng(5)
    biased = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.2 * rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "bias" else x, jrunner.params)
    jrunner = jrunner.replace(params=biased, opt_state=tx.init(biased))
    cfg = seac.SEACPPOConfig(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS,
                             minibatches=MINIBATCHES)
    dims = BlockDims(env.config.flattened_obs_length, 128, 128, 5)
    runner = ippo.RunnerState(
        params=seac_params_from_flax(jax.tree.map(np.asarray, jrunner.params)),
        opt_state=seac_opt_state_from_optax(jax.tree.map(np.asarray, jrunner.opt_state)),
        env_states=to_port(jrunner.env_states), obs=None, generator=torch.Generator(),
        update_idx=0, seed=0)
    step = seac.build_seac_ppo_fused_train_step(env, dims, cfg, deterministic_collect=True)
    ts = compile_bf16_exact(
        jax_seac.build_seac_ppo_train_step(jenv, model, tx, jcfg, collect_mode="pallas",
                                           interpret=True, deterministic_collect=True,
                                           update_mode="fused"), jrunner)
    history = []
    for _ in range(N_UPDATES):
        offsets = jax_offsets(jrunner)
        jrunner, jmetrics = ts(jrunner)
        runner, metrics = step(runner, offsets)
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
    """After each update: every agent's parameters within 0.05 * lr * P,
    optimizer count and update index equal, metrics within rtol 1e-2 (or
    1e-4), the env states equal in the envs whose actions agreed."""
    cfg, dims, history, _ = chained_pair
    jrunner, jmetrics, runner, metrics, _ = history[u]
    p = cfg.epochs * cfg.minibatches
    want = seac_params_from_flax(jax.tree.map(np.asarray, jrunner.params))
    assert runner.params.shape == want.shape == (2, dims.n_params)
    np.testing.assert_allclose(runner.params.numpy(), want.numpy(), atol=0.05 * cfg.lr * p,
                               rtol=1e-3)
    assert runner.opt_state.count == int(jrunner.opt_state[1][0].count) == p * (u + 1)
    assert runner.update_idx == int(jrunner.update_idx) == u + 1
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-2, atol=1e-4, err_msg=k)
    same = np.all(runner.env_states.agent_x.numpy() == np.asarray(jrunner.env_states.agent_x), 1) \
        & np.all(runner.env_states.agent_y.numpy() == np.asarray(jrunner.env_states.agent_y), 1)
    assert same.mean() >= 0.95, same.mean()


def test_update_moved_every_block_of_every_agent(chained_pair):
    cfg, dims, history, step = chained_pair
    first, last = history[0][2], history[-1][2]
    for i in range(2):
        for k, (a, b) in enumerate(zip(dims.split(first.params[i]), dims.split(last.params[i]))):
            assert float((a - b).abs().max()) > 0, f"agent {i} block {k} did not move"
    assert step.collect.launches == step.grads.launches == 0  # CPU: the plain versions
    back = seac_params_to_flax(last.params, dims)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), atol=1e-2),
                 back, jax.tree.map(np.asarray, history[-1][0].params))


def test_plain_learner_runs_and_learns_something():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu", max_steps=6)
    cfg = seac.SEACPPOConfig(n_envs=16, rollout_len=8, epochs=2, minibatches=2)
    runner, dims = seac.init_seac_ppo(env, cfg, seed=0)
    step = seac.build_seac_ppo_train_step(env, dims, cfg)
    new, metrics = step(runner)
    new2, _ = step(new)
    assert float((new.params - runner.params).abs().max()) > 0
    assert new2.update_idx == 2 and new2.opt_state.count == 8
    assert int(metrics["episodes_done"]) == 16  # episodes of 6 steps end inside the rollout
    assert set(metrics) == {"reward_per_env", "episodes_done", *ippo.METRIC_KEYS}
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    assert float(metrics["entropy"]) > 0.9 * np.log(5)  # near-uniform policies at init


def test_fused_learner_draws_its_own_offsets():
    """Without offsets the fused learner draws E of them from the runner's
    generator: two runners of one seed take the same update."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu")
    cfg = seac.SEACPPOConfig(n_envs=16, rollout_len=8, epochs=2, minibatches=2)
    a, dims = seac.init_seac_ppo(env, cfg, seed=1)
    b, _ = seac.init_seac_ppo(env, cfg, seed=1)
    step = seac.build_seac_ppo_fused_train_step(env, dims, cfg)
    a, _ = step(a)
    b, _ = step(b)
    assert torch.equal(a.params, b.params) and a.opt_state.count == 4
    with pytest.raises(ValueError, match="must divide"):
        seac.build_seac_ppo_fused_train_step(env, dims, seac.SEACPPOConfig(rollout_len=6))


def test_train_and_evaluate_entry_points_seac(tmp_path):
    out = train.main(["--algo", "seac-ppo", "--device", "cpu", "--n-envs", "32",
                      "--rollout-len", "8", "--updates", "2", "--log-every", "1",
                      "--checkpoint-dir", str(tmp_path)])
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl", "reward_per_env",
              "episodes_done", "env_steps_per_s"):
        assert np.isfinite(out[k]), k
    ckpt = torch.load(str(tmp_path / "policy.pt"))
    assert ckpt["net"] == "mlp" and ckpt["per_agent"] == 2
    env_id, policies = train.load_policy(str(tmp_path / "policy.pt"))
    assert env_id == "rware-tiny-2ag-v2" and isinstance(policies, torch.nn.ModuleList)
    assert len(policies) == 2
    assert not torch.equal(policies[0].dense[0].weight, policies[1].dense[0].weight)
    stats = evaluate.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path),
                           "--episodes", "8", "--max-steps", "40"])
    assert stats["episodes"] == 8 and np.isfinite(stats["mean_return"])
    assert stats["mean_length"] <= 40
    train.main(["--algo", "seac-ppo", "--collect", "plain", "--device", "cpu", "--n-envs", "16",
                "--rollout-len", "4", "--updates", "1", "--checkpoint-dir", str(tmp_path / "p")])
    assert torch.load(str(tmp_path / "p" / "policy.pt"))["per_agent"] == 2


def test_seac_entry_point_refuses_what_is_not_there():
    with pytest.raises(NotImplementedError, match="no such learner"):
        train.main(["--algo", "seac-ppo", "--fused-critic-phase", "--device", "cpu"])
    with pytest.raises(ValueError, match="MLP policies only"):
        train.main(["--algo", "seac", "--net", "gru", "--device", "cpu"])
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu", msg_bits=1)
    _, dims = seac.init_seac_ppo(env, seac.SEACPPOConfig(n_envs=8), 0)
    with pytest.raises(NotImplementedError, match="no message head"):  # K8 has no message head
        seac.build_seac_ppo_fused_train_step(env, dims, seac.SEACPPOConfig(n_envs=8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--algo", "seac-ppo", "--updates", "1"])
