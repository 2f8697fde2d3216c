"""The loss-fused recurrent IPPO update as a whole, on the CPU: three
chained updates of the port's learner with ``fused_loss=True`` (per env band
K11 and K13, the embed and input-gate products in torch: ``rnn_fused_grads``)
against the JAX package's ``build_rnn_pallas_train_step(interpret=True,
deterministic_collect=True, fused_loss=True)`` with its Pallas GRU kernels
selected (``GRU_SEQ_IMPL = "pallas_interpret"``; on the CPU its "auto" picks
the XLA path and would skip them), 1,024 envs, T=8, E=2, M=2, as
``tests/test_torch_rnn_mappo_train.py`` holds recurrent MAPPO: a resynced
and a carried port runner, JAX's own epoch offsets handed over.

Tolerances as ``tests/test_torch_rnn_train.py``: parameters within 0.05 *
lr * P after P Adam steps, metrics within rtol 1e-2, the carry within 5e-2
and the env states equal in the envs whose deterministic actions agreed (at
least 95%).
"""
import dataclasses

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
from rware_tpu_torch.models.networks import GruDims
from tests.test_torch_rnn_mappo_train import (
    EMBED,
    HG,
    MAX_STEPS,
    N_UPDATES,
    T_LEN,
    assert_states_and_carry,
    biased,
    jax_offsets,
)
from tests.torch_ref import compile_bf16_exact, make_pair, to_port

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fused_loss_chain():
    """Three chained loss-fused recurrent IPPO updates on each side."""
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", max_steps=MAX_STEPS).config)
    kw = dict(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=2, minibatches=2)
    jcfg, cfg = JaxConfig(**kw), ippo.IPPOConfig(**kw)
    model = FlaxRecurrent(n_actions=5, hidden=HG, embed=EMBED)
    jrunner, model, tx = jax_rnn.init_rnn_runner(jenv, jcfg, jax.random.key(1), model)
    params = biased(jrunner.params, 5)
    jrunner = jrunner.replace(params=params, opt_state=tx.init(params))
    dims = GruDims(env.config.flattened_obs_length, EMBED, HG, 5)

    def port_runner(jr):
        return ippo_rnn.RNNRunnerState(
            params=gru_params_from_flax(jax.tree.map(np.asarray, jr.params)),
            opt_state=adam_state_from_optax(jax.tree.map(np.asarray, jr.opt_state),
                                            from_flax=gru_params_from_flax),
            env_states=to_port(jr.env_states), obs=None,
            carry=torch.from_numpy(np.array(jr.carry.astype(jnp.float32))).to(torch.bfloat16),
            generator=torch.Generator(), update_idx=0, seed=0)

    step = ippo_rnn.build_rnn_fused_train_step(env, dims, cfg, deterministic_collect=True,
                                               fused_loss=True)
    synced = carried = port_runner(jrunner)
    history = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rnn, "GRU_SEQ_IMPL", "pallas_interpret")
        ts = compile_bf16_exact(
            jax_rnn.build_rnn_pallas_train_step(jenv, model, tx, jcfg, interpret=True,
                                                deterministic_collect=True, fused_loss=True),
            jrunner)
        for u in range(N_UPDATES):
            offsets = jax_offsets(jrunner, cfg.epochs, ENV_BLOCK // LANE)
            fresh = port_runner(jrunner)
            synced = dataclasses.replace(synced, params=fresh.params, opt_state=fresh.opt_state)
            jrunner, jmetrics = ts(jrunner)
            synced, metrics = step(synced, offsets)
            carried, _ = step(carried, offsets)
            history.append((jrunner, jmetrics, synced, metrics, carried))
    return cfg, history, step


def test_fused_loss_learner_takes_k11_and_k13(fused_loss_chain):
    _, history, step = fused_loss_chain
    assert step.fused_loss and step.loss_bwd is not None
    assert step.seq_fwd.launches == step.loss_bwd.launches == 0  # CPU: the plain versions
    assert step.gru_fwd.launches == step.gru_bwd.launches == 0
    done = [int(h[3]["episodes_done"]) for h in history]
    assert done == [int(h[1]["episodes_done"]) for h in history]
    assert done[0] == 0 and min(done[1:]) == ENV_BLOCK, done


@pytest.mark.parametrize("carried", [False, True], ids=["resynced", "carried"])
@pytest.mark.parametrize("u", range(N_UPDATES))
def test_fused_loss_update_matches_jax(fused_loss_chain, u, carried):
    """Parameters within 0.05 * lr * P of JAX's, counts equal, the metrics
    of the resynced runner within rtol 1e-2, env states and carry in the
    agreeing envs."""
    cfg, history, _ = fused_loss_chain
    jrunner, jmetrics, synced, metrics, carried_runner = history[u]
    runner = carried_runner if carried else synced
    p = cfg.epochs * cfg.minibatches
    want = gru_params_from_flax(jax.tree.map(np.asarray, jrunner.params))
    np.testing.assert_allclose(runner.params.numpy(), want.numpy(), atol=0.05 * cfg.lr * p,
                               rtol=1e-3)
    assert runner.opt_state.count == int(jrunner.opt_state[1][0].count) == p * (u + 1)
    assert runner.update_idx == int(jrunner.update_idx) == u + 1
    if not carried:
        for k, v in metrics.items():
            np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-2, atol=1e-6,
                                       err_msg=k)
    assert_states_and_carry(runner, jrunner)


def test_train_fused_loss_entry_point_and_refusals(tmp_path):
    """``train --net gru --fused-loss`` on the CPU; with message bits the
    learner refuses and says why; on another learner the flag refuses."""
    out = train.main(["--net", "gru", "--fused-loss", "--device", "cpu", "--n-envs", "128",
                      "--rollout-len", "8", "--updates", "1", "--checkpoint-dir",
                      str(tmp_path)])
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl"):
        assert np.isfinite(out[k]), k
    assert torch.load(str(tmp_path / "policy.pt"))["net"] == "gru"
    with pytest.raises(ValueError, match="takes no message bits"):
        train.main(["--net", "gru", "--fused-loss", "--msg-bits", "2", "--device", "cpu",
                    "--n-envs", "128", "--rollout-len", "8", "--updates", "1"])
    for argv in (["--fused-loss"], ["--algo", "mappo", "--net", "gru", "--fused-loss"]):
        with pytest.raises(ValueError, match="recurrent IPPO learner's option"):
            train.main(argv + ["--device", "cpu"])
