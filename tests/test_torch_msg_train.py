"""IPPO with message bits as a whole, on the CPU: three chained updates of
the port's fused learner (the collector's message mode K2b, then per pass
K4 with the message head and the optimizer step: K3 has no message head)
against the JAX package's ``build_pallas_train_step(interpret=True,
deterministic_collect=True)`` on ``msg_bits=2``, each side carrying its own
runner across episode ends, with the JAX update's window starts handed over;
and ``train --msg-bits`` / ``evaluate`` on the CPU.

Tolerances: parameters within 0.05 * lr * P after P Adam steps (Adam
normalises the gradient, so a step is at most about lr; the two sides'
gradients differ by float32 summation order and bf16 rounding flips),
metrics within rtol 1e-2; env states, messages and observations equal.
"""
import jax
import numpy as np
import pytest
import torch

import rware_tpu
from rware_tpu.models import IPPOConfig as JaxConfig
from rware_tpu.models import ippo_pallas as jax_native
from rware_tpu.ops.pallas_rollout import ENV_BLOCK
from rware_tpu.ops.pallas_update import phase_time_block as jax_time_block
from rware_tpu_torch import evaluate, train
from rware_tpu_torch.convert import adam_state_from_optax, params_from_flax
from rware_tpu_torch.models import ippo
from rware_tpu_torch.models.ippo_fused import build_fused_train_step
from rware_tpu_torch.models.networks import ActorCritic, BlockDims
from tests.torch_ref import ALL_FIELDS, assert_fields_equal, compile_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

T_LEN, EPOCHS, MINIBATCHES, M = 8, 2, 2, 2
# episodes of MAX_STEPS end inside the 2nd and 3rd updates
N_UPDATES, MAX_STEPS = 3, 12


@pytest.fixture(scope="module")
def chained_pair():
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", max_steps=MAX_STEPS,
                                         msg_bits=M).config)
    jcfg = JaxConfig(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS,
                     minibatches=MINIBATCHES)
    jrunner, model, tx = jax_native.init_pallas_runner(jenv, jcfg, jax.random.key(1))
    assert model.msg_bits == M
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
    dims = BlockDims(env.config.flattened_obs_length, 128, 128, 5, M)
    step = build_fused_train_step(env, dims, cfg, deterministic_collect=True)
    history = []
    for _ in range(N_UPDATES):
        k_perm = jax.random.split(jrunner.key, 2)[1]
        starts = jax_native.phase_window_starts(
            jcfg, T_LEN, jax_time_block(T_LEN // MINIBATCHES), k_perm)
        jrunner, jmetrics = ts(jrunner)
        runner, metrics = step(runner, torch.from_numpy(np.array(starts)).to(torch.int64))
        history.append((jrunner, jmetrics, runner, metrics))
    return cfg, dims, history, step


def test_per_pass_path_and_episode_ends(chained_pair):
    _, _, history, step = chained_pair
    assert step.update_phase is None  # no K3 with message bits: K4 per pass
    assert step.collect.launches == step.grads.launches == 0  # CPU: the plain versions
    done = [int(h[3]["episodes_done"]) for h in history]
    assert done == [int(h[1]["episodes_done"]) for h in history]
    assert done[0] == 0 and min(done[1:]) == ENV_BLOCK, done


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_chained_update_matches_jax(chained_pair, u):
    cfg, dims, history, _ = chained_pair
    jrunner, jmetrics, runner, metrics = history[u]
    assert_fields_equal(runner.env_states, jrunner.env_states, ALL_FIELDS + ("agent_message",))
    # the bits were sampled and kept; the 3rd update's last step ends every episode
    assert bool(runner.env_states.agent_message.any()) == (u < N_UPDATES - 1)
    np.testing.assert_array_equal(runner.obs.float().numpy(),
                                  np.asarray(jrunner.obs, dtype=np.float32))
    p = cfg.epochs * cfg.minibatches
    want = params_from_flax(jax.tree.map(np.asarray, jrunner.params))
    np.testing.assert_allclose(runner.params.numpy(), want.numpy(), atol=0.05 * cfg.lr * p,
                               rtol=1e-3)
    message = dims.split(runner.params - history[0][2].params)[4][:, dims.n_actions + 1:]
    assert u == 0 or float(message.abs().max()) > 0  # the message head learns
    assert runner.opt_state.count == int(jrunner.opt_state[1][0].count) == p * (u + 1)
    assert runner.update_idx == int(jrunner.update_idx) == u + 1
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-2, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("extra", [[], ["--collect", "plain"]], ids=["fused", "plain"])
def test_train_msg_bits_and_evaluate(tmp_path, extra):
    out = train.main(["--device", "cpu", "--n-envs", "128", "--rollout-len", "8",
                      "--updates", "1", "--msg-bits", "2",
                      "--checkpoint-dir", str(tmp_path)] + extra)
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl", "reward_per_env"):
        assert np.isfinite(out[k]), k
    assert out["entropy"] > np.log(5)  # the joint entropy
    ckpt = torch.load(str(tmp_path / "policy.pt"))
    assert ckpt["msg_bits"] == 2 and ckpt["obs_dim"] == 89
    _, policy = train.load_policy(str(tmp_path / "policy.pt"))
    assert isinstance(policy, ActorCritic) and policy.msg_bits == 2
    stats = evaluate.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path),
                           "--episodes", "8", "--max-steps", "20"])
    assert stats["episodes"] == 8 and np.isfinite(stats["mean_return"])
