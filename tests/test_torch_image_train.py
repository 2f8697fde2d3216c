"""The image slice as a whole, on the CPU: three chained updates of the
port's fused IPPO learner and of its fused recurrent learner on
``rware-img-tiny-2ag-v2`` against the JAX package's
``build_pallas_train_step`` / ``build_rnn_pallas_train_step``
(``interpret=True, deterministic_collect=True``; the recurrent one with the
Pallas GRU sequence kernels), each side carrying its own runner across
episode ends, with only JAX's window starts or epoch offsets handed over;
and the ``train`` / ``evaluate`` entry points of every learner on ``-img``,
``-imgdict`` and ``-Nd`` ids.

Tolerances, those of ``tests/test_torch_train.py`` and
``tests/test_torch_rnn_train.py``: parameters within 0.05 * lr * P after P
Adam steps, metrics within rtol 1e-2; the IPPO runner's env states and
observations equal; the recurrent runner's carry within 5e-2 in the envs
whose actions agreed (at least 95% of them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
from rware_tpu.models import IPPOConfig as JaxConfig
from rware_tpu.models import ippo_pallas as jax_native
from rware_tpu.models import ippo_rnn as jax_rnn
from rware_tpu.models.networks import RecurrentActorCritic as FlaxRecurrent
from rware_tpu.ops.pallas_rollout import ENV_BLOCK, LANE
from rware_tpu.ops.pallas_update import phase_time_block as jax_time_block
from rware_tpu_torch import evaluate, train
from rware_tpu_torch.convert import adam_state_from_optax, gru_params_from_flax, params_from_flax
from rware_tpu_torch.models import ippo, ippo_rnn
from rware_tpu_torch.models.ippo_fused import build_fused_train_step
from rware_tpu_torch.models.networks import BlockDims, GruDims, RecurrentActorCritic
from tests.test_torch_rnn_train import jax_offsets
from tests.torch_ref import ALL_FIELDS, assert_fields_equal, compile_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

ENV_ID = "rware-img-tiny-2ag-v2"
T_LEN, EPOCHS, MINIBATCHES, EMBED, HG = 8, 2, 2, 32, 32
# episodes of MAX_STEPS end inside the 2nd and 3rd updates
N_UPDATES, MAX_STEPS = 3, 12


def _cfgs():
    return (JaxConfig(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS,
                      minibatches=MINIBATCHES),
            ippo.IPPOConfig(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=EPOCHS,
                            minibatches=MINIBATCHES))


@pytest.fixture(scope="module")
def ippo_chain():
    jenv, env = make_pair(rware_tpu.make(ENV_ID, max_steps=MAX_STEPS).config)
    jcfg, cfg = _cfgs()
    jrunner, model, tx = jax_native.init_pallas_runner(jenv, jcfg, jax.random.key(1))
    ts = compile_bf16_exact(
        jax_native.build_pallas_train_step(jenv, model, tx, jcfg, interpret=True,
                                           deterministic_collect=True), jrunner)
    runner = ippo.RunnerState(
        params=params_from_flax(jax.tree.map(np.asarray, jrunner.params)),
        opt_state=adam_state_from_optax(jax.tree.map(np.asarray, jrunner.opt_state)),
        env_states=to_port(jrunner.env_states), obs=None, generator=torch.Generator(),
        update_idx=0, seed=0)
    dims = BlockDims(env.config.policy_obs_length, 128, 128, 5)
    step = build_fused_train_step(env, dims, cfg, deterministic_collect=True)
    history = []
    for _ in range(N_UPDATES):
        k_perm = jax.random.split(jrunner.key, 2)[1]
        starts = jax_native.phase_window_starts(
            jcfg, T_LEN, jax_time_block(T_LEN // MINIBATCHES), k_perm)
        jrunner, jmetrics = ts(jrunner)
        runner, metrics = step(runner, torch.from_numpy(np.array(starts)).to(torch.int64))
        history.append((jrunner, jmetrics, runner, metrics))
    return cfg, history, step


@pytest.fixture(scope="module")
def rnn_chain():
    jenv, env = make_pair(rware_tpu.make(ENV_ID, max_steps=MAX_STEPS).config)
    jcfg, cfg = _cfgs()
    model = FlaxRecurrent(n_actions=5, hidden=HG, embed=EMBED)
    jrunner, model, tx = jax_rnn.init_rnn_runner(jenv, jcfg, jax.random.key(1), model)
    rng = np.random.default_rng(5)
    biased = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.2 * rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "bias" else x, jrunner.params)
    jrunner = jrunner.replace(params=biased, opt_state=tx.init(biased))
    dims = GruDims(env.config.policy_obs_length, EMBED, HG, 5)
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
    return cfg, history, step


def _check_common(cfg, jrunner, jmetrics, runner, metrics, u, from_flax):
    p = cfg.epochs * cfg.minibatches
    want = from_flax(jax.tree.map(np.asarray, jrunner.params))
    np.testing.assert_allclose(runner.params.numpy(), want.numpy(), atol=0.05 * cfg.lr * p,
                               rtol=1e-3)
    assert runner.opt_state.count == int(jrunner.opt_state[1][0].count) == p * (u + 1)
    assert runner.update_idx == int(jrunner.update_idx) == u + 1
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-2, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("chain", ["ippo", "rnn"])
def test_chained_updates_cross_episode_ends(chain, request):
    _, history, step = request.getfixturevalue(f"{chain}_chain")
    done = [int(h[3]["episodes_done"]) for h in history]
    assert done == [int(h[1]["episodes_done"]) for h in history]
    assert done[0] == 0 and min(done[1:]) == ENV_BLOCK, done
    assert step.collect.launches == 0  # CPU tensors take the plain version
    assert step.collect.obs_len == 45


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_chained_ippo_update_matches_jax(ippo_chain, u):
    """After each update: env states and (flat image) observations equal,
    parameters, optimizer count, update index and metrics as JAX's."""
    cfg, history, _ = ippo_chain
    jrunner, jmetrics, runner, metrics = history[u]
    assert_fields_equal(runner.env_states, jrunner.env_states, ALL_FIELDS)
    assert tuple(runner.obs.shape) == (ENV_BLOCK, 2, 45)
    np.testing.assert_array_equal(runner.obs.float().numpy(),
                                  np.asarray(jrunner.obs, dtype=np.float32))
    _check_common(cfg, jrunner, jmetrics, runner, metrics, u, params_from_flax)


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_chained_rnn_update_matches_jax(rnn_chain, u):
    cfg, history, _ = rnn_chain
    jrunner, jmetrics, runner, metrics = history[u]
    _check_common(cfg, jrunner, jmetrics, runner, metrics, u, gru_params_from_flax)
    same = np.all(runner.env_states.agent_x.numpy() == np.asarray(jrunner.env_states.agent_x), 1) \
        & np.all(runner.env_states.agent_y.numpy() == np.asarray(jrunner.env_states.agent_y), 1)
    assert same.mean() >= 0.95, same.mean()
    carry = runner.carry.float().numpy()
    jcarry = np.asarray(jrunner.carry.astype(jnp.float32))
    np.testing.assert_allclose(carry[same], jcarry[same], atol=5e-2)


@pytest.mark.parametrize("env_id,extra", [
    ("rware-img-tiny-2ag-v2", []),
    ("rware-imgdict-tiny-2ag-v2", ["--net", "gru"]),
    ("rware-img-Nd-tiny-2ag-v2", []),
    ("rware-img-tiny-2ag-v2", ["--algo", "mappo"]),
    ("rware-imgdict-tiny-2ag-v2", ["--algo", "mappo", "--fused-critic-phase"]),
    ("rware-img-tiny-2ag-v2", ["--algo", "seac-ppo"]),
    ("rware-imgdict-tiny-2ag-v2", ["--algo", "seac-ppo", "--net", "gru", "--msg-bits", "2"]),
    ("rware-img-tiny-2ag-v2", ["--msg-bits", "2"]),
], ids=lambda v: "_".join(a.lstrip("-") for a in v) or "ippo" if isinstance(v, list) else v)
def test_train_and_evaluate_entry_points_on_image_ids(tmp_path, env_id, extra):
    """Every learner the port has trains on image ids, its policy taking
    ``policy_obs_length`` features, and ``evaluate`` plays the checkpoint
    and the random baseline."""
    out = train.main(["--env", env_id, "--device", "cpu", "--n-envs", "32", "--rollout-len", "8",
                      "--updates", "2", "--log-every", "1", "--checkpoint-dir", str(tmp_path)]
                     + extra)
    for k in ("pg_loss", "v_loss", "entropy", "reward_per_env", "env_steps_per_s"):
        assert np.isfinite(out[k]), k
    got_id, policy = train.load_policy(str(tmp_path / "policy.pt"))
    assert got_id == env_id
    net = policy[0] if isinstance(policy, torch.nn.ModuleList) else policy
    assert net.obs_dim == rware_tpu.parse_env_id(env_id).policy_obs_length
    assert isinstance(net, RecurrentActorCritic) == ("gru" in extra)
    stats = evaluate.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path),
                           "--episodes", "8", "--max-steps", "20"])
    assert stats["episodes"] == 8 and np.isfinite(stats["mean_return"])
    rand = evaluate.main(["--device", "cpu", "--env", env_id, "--random", "--episodes", "8",
                          "--max-steps", "20"])
    assert np.isfinite(rand["mean_return"]) and rand["mean_length"] <= 20
