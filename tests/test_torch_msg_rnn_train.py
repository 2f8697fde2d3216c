"""Recurrent IPPO with message bits as a whole, on the CPU: three chained
updates of the port's fused recurrent learner (the recurrent collector's
message mode K2b, then per env-band pass K9, the heads and the joint move +
Bernoulli loss by autograd, K10) against the JAX package's
``build_rnn_pallas_train_step(interpret=True, deterministic_collect=True)``
with the Pallas GRU sequence kernels selected, on ``msg_bits=2``, from the
same env states, parameters (biases made nonzero) and optimizer state, with
JAX's own epoch offsets handed over (as ``tests/test_torch_rnn_train.py``);
and ``train --net gru --msg-bits``.

Tolerances as ``tests/test_torch_rnn_train.py``: parameters within 0.05 *
lr * P, metrics within rtol 1e-2, the carry within 5e-2 and env states equal
in the envs whose deterministic actions and bits agreed (at least 95%).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
from rware_tpu.models import IPPOConfig as JaxConfig
from rware_tpu.models import ippo_rnn as jax_rnn
from rware_tpu.models.networks import RecurrentActorCritic as FlaxRecurrent
from rware_tpu.ops.pallas_rollout import ENV_BLOCK, LANE
from rware_tpu_torch import train
from rware_tpu_torch.convert import adam_state_from_optax, gru_params_from_flax
from rware_tpu_torch.models import ippo, ippo_rnn
from rware_tpu_torch.models.networks import GruDims, RecurrentActorCritic
from tests.test_torch_rnn_train import jax_offsets
from tests.torch_ref import compile_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

T_LEN, EPOCHS, MINIBATCHES, EMBED, HG, M = 8, 2, 2, 32, 32, 2
N_UPDATES, MAX_STEPS = 3, 12


@pytest.fixture(scope="module")
def chained_pair():
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", max_steps=MAX_STEPS,
                                         msg_bits=M).config)
    jcfg = JaxConfig(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS,
                     minibatches=MINIBATCHES)
    model = FlaxRecurrent(n_actions=5, hidden=HG, embed=EMBED, msg_bits=M)
    jrunner, model, tx = jax_rnn.init_rnn_runner(jenv, jcfg, jax.random.key(1), model)
    rng = np.random.default_rng(5)
    biased = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.2 * rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "bias" else x, jrunner.params)
    jrunner = jrunner.replace(params=biased, opt_state=tx.init(biased))
    dims = GruDims(env.config.flattened_obs_length, EMBED, HG, 5, M)
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
            history.append((jrunner, jmetrics, runner, metrics))
    return cfg, dims, history, step


def test_chained_updates_cross_episode_ends(chained_pair):
    _, _, history, step = chained_pair
    done = [int(h[3]["episodes_done"]) for h in history]
    assert done == [int(h[1]["episodes_done"]) for h in history]
    assert done[0] == 0 and min(done[1:]) == ENV_BLOCK, done
    assert step.collect.launches == step.gru_fwd.launches == step.gru_bwd.launches == 0  # CPU


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_chained_update_matches_jax(chained_pair, u):
    cfg, dims, history, _ = chained_pair
    jrunner, jmetrics, runner, metrics = history[u]
    p = cfg.epochs * cfg.minibatches
    want = gru_params_from_flax(jax.tree.map(np.asarray, jrunner.params))
    np.testing.assert_allclose(runner.params.numpy(), want.numpy(), atol=0.05 * cfg.lr * p,
                               rtol=1e-3)
    assert runner.opt_state.count == int(jrunner.opt_state[1][0].count) == p * (u + 1)
    assert runner.update_idx == int(jrunner.update_idx) == u + 1
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-2, atol=1e-6, err_msg=k)
    st, jst = runner.env_states, jrunner.env_states
    same = np.all(st.agent_x.numpy() == np.asarray(jst.agent_x), 1) \
        & np.all(st.agent_y.numpy() == np.asarray(jst.agent_y), 1) \
        & np.all(st.agent_message.numpy() == np.asarray(jst.agent_message), (1, 2))
    assert same.mean() >= 0.95, same.mean()
    np.testing.assert_allclose(runner.carry.float().numpy()[same],
                               np.asarray(jrunner.carry.astype(jnp.float32))[same], atol=5e-2)
    message = dims.split(runner.params - history[0][2].params)[6][:, dims.n_actions + 1:]
    assert u == 0 or float(message.abs().max()) > 0  # the message head learns


def test_train_gru_msg_bits(tmp_path):
    out = train.main(["--device", "cpu", "--net", "gru", "--n-envs", "128", "--rollout-len",
                      "8", "--updates", "1", "--msg-bits", "2",
                      "--checkpoint-dir", str(tmp_path)])
    assert np.isfinite(out["pg_loss"]) and out["entropy"] > np.log(5)
    _, policy = train.load_policy(str(tmp_path / "policy.pt"))
    assert isinstance(policy, RecurrentActorCritic) and policy.msg_bits == 2
