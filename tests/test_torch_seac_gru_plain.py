"""Recurrent SEAC-PPO on JAX's XLA collect, on the CPU: the port's ``train
--algo seac-ppo --net gru --collect plain`` learner
(``seac.build_seac_gru_train_step(collect="plain")``) against the JAX
package's ``build_seac_gru_train_step(collect_mode="xla")``, without and with
two message bits (tiny-2ag, B=16, T=8, E=2, M=2, embed and GRU 32; the biases
made nonzero, as training moves them).

* Collect, fixed actions: JAX's own XLA collect (the scan of its ``collect``
  closure with its train step's key) hands its actions to the port's plain
  collect from the same states, parameters and zero carry.  No episode ends
  and no shelf is delivered inside the window: obs, rewards, done, the env
  state and the carry are equal bit for bit, the joint ``logp`` within 1e-5.
* Collect, free sampling: from a batch of scripted states (agent 0 one step
  from the goal with a requested shelf), eight rollouts a side (the port's
  Philox seeds against JAX's keys): each move's and each bit's frequency and
  the share of steps with a reward within 5 sigma of a binomial difference.
* Update: the port's cross replay, bootstrap, cross GAE and E x M band passes
  on JAX's own trajectory with JAX's env offsets, against JAX's whole
  ``train_step``: env states and carry equal, metrics within rtol 2e-2, atol
  2e-3, and the parameters as ``tests/test_torch_dp_placement_jax.py`` holds
  them: within 0.05 * lr * P (rtol 1e-3) for at least 99.5% of them, and each
  of the rest one whose gradient was near zero at some step, its
  bias-corrected Adam mean |mu / (1 - 0.9^k)| at most 5e-5 after some step k
  <= P (the port's moments: JAX's scan keeps its per-step moments inside).
  The replay's gradient agrees with JAX's autodiff to about 0.4% of each
  block's largest (its bf16 roundings), and Adam moves a parameter whose
  gradient is near zero by up to lr a step: 0.1% of the parameters part by up
  to 1.5 lr, each with a least Adam mean under 3.5e-5.
* The first epoch's own-stream ratio: the first band's ``approx_kl`` before
  any step, each side on the trajectory of its own collect, no further from 0
  than JAX's (1e-9 of slack): the collect and the replay both run the flax
  module's rounding.
* Mesh: two emulated ranks (``testing.emulate_mesh``) equal the per-shard
  computation bit for bit (each rank's env bands its shard's, each band's
  gradients the mean of the shards').
* Resume, and ``train --collect plain`` / ``evaluate``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.models import ippo as jax_ippo
from rware_tpu.models import seac as jax_seac
from rware_tpu.models.networks import RecurrentActorCritic as FlaxRecurrent
from rware_tpu.testing import DOWN, UP
from rware_tpu.testing import make_state as jax_make_state
from rware_tpu_torch import evaluate, train
from rware_tpu_torch.checkpoint import Checkpointer
from rware_tpu_torch.convert import seac_opt_state_from_optax, seac_params_from_flax
from rware_tpu_torch.models import seac
from rware_tpu_torch.models.ippo import mean_metrics, policy_obs_fn
from rware_tpu_torch.models.ippo_rnn import RNNRunnerState, band_slice
from rware_tpu_torch.models.networks import GruDims
from rware_tpu_torch.models.ppo import loss_grads
from rware_tpu_torch.testing import emulate_mesh
from tests.test_torch_checkpoint import assert_runners_equal
from tests.test_torch_mappo_plain import LOGP_ATOL, METRIC_TOL, binomial_close
from tests.torch_ref import ALL_FIELDS, assert_fields_equal, compile_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

ENV = "rware-tiny-2ag-v2"
B, T_LEN, EPOCHS, MINIBATCHES, HG = 16, 8, 2, 2, 32
N_ROLLOUTS = 8  # of each side, for the sampling laws
KL_SLACK = 1e-9
PARAM_SHARE = 0.995  # of the parameters within 0.05 * lr * P, rtol 1e-3
NEAR_ZERO_GRAD = 5e-5  # the bias-corrected Adam mean that counts as a near-zero gradient
ADAM_B1 = 0.9


def _closure(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def from_jax(traj, msg):
    """The port's trajectory dict of JAX's ``SEACTransition`` (T, B, ...)."""
    action = torch.from_numpy(np.array(traj.action))
    out = {"obs": torch.from_numpy(np.array(traj.obs)).to(torch.bfloat16),
           "action": action[..., 0].contiguous() if msg else action,
           "logp": torch.from_numpy(np.array(traj.logp)),
           "reward": torch.from_numpy(np.array(traj.reward)),
           "done": torch.from_numpy(np.array(traj.done))}
    if msg:
        out["bits"] = action[..., 1:].contiguous()
    return out


def port_runner(jrunner, env):
    states = to_port(jrunner.env_states)
    return RNNRunnerState(
        params=seac_params_from_flax(jax.tree.map(np.asarray, jrunner.params)),
        opt_state=seac_opt_state_from_optax(jax.tree.map(np.asarray, jrunner.opt_state)),
        env_states=states, obs=policy_obs_fn(env)(states),
        carry=torch.from_numpy(np.array(jrunner.carry.astype(jnp.float32))).to(torch.bfloat16),
        generator=torch.Generator(), update_idx=0, seed=0)


def scripted_batch(jenv):
    def one(seed):
        return jax_make_state(jenv.config, [(4, 9, DOWN), (0, 0, UP)], carrying=[0, -1],
                              queue=[0, 1], seed=seed)
    return jax.vmap(one)(jnp.arange(B))


@pytest.fixture(scope="module", params=[0, 2], ids=["M0", "M2"])
def case(request):
    msg = request.param
    jenv, env = make_pair(rware_tpu.make(ENV, msg_bits=msg).config)
    jcfg = jax_seac.SEACPPOConfig(n_envs=B, rollout_len=T_LEN, epochs=EPOCHS,
                                  minibatches=MINIBATCHES)
    model = FlaxRecurrent(n_actions=5, hidden=HG, embed=HG, msg_bits=msg)
    jrunner, model, tx = jax_seac.init_seac_gru(jenv, jcfg, jax.random.key(2), model)
    rng = np.random.default_rng(7 + msg)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + (0.2 * rng.standard_normal(x.shape)).astype(np.float32)
        if path[-1].key == "bias" else np.asarray(x), jrunner.params)
    jrunner = jrunner.replace(params=params, opt_state=tx.init(params))
    ts = jax_seac.build_seac_gru_train_step(jenv, model, tx, jcfg, collect_mode="xla")
    body = _closure(ts, "collect")

    def rollout(params, states, obs, carry, key):  # seac.py:1048-1059
        (_, states, obs, carry), traj = jax.lax.scan(
            body, (params, states, obs, carry), jax.random.split(key, T_LEN))
        return states, carry, traj

    _, k_roll, k_perm = jax.random.split(jrunner.key, 3)
    args = (jrunner.params, jrunner.env_states, jrunner.obs, jrunner.carry, k_roll)
    collect = compile_bf16_exact(rollout, *args)
    jstates, jcarry, jtraj = collect(*args)
    jnew, jmetrics = compile_bf16_exact(ts, jrunner)(jrunner)
    offsets = [int(jax.random.randint(k, (), 0, B)) for k in jax.random.split(k_perm, EPOCHS)]
    scripted = scripted_batch(jenv)
    sobs = jax.vmap(jax_ippo.policy_obs_fn(jenv))(scripted)
    sampled = [from_jax(collect(jrunner.params, scripted, sobs, jrunner.carry,
                                jax.random.key(100 + i))[2], msg) for i in range(N_ROLLOUTS)]
    cfg = seac.SEACPPOConfig(n_envs=B, rollout_len=T_LEN, epochs=EPOCHS,
                             minibatches=MINIBATCHES)
    dims = GruDims(env.config.policy_obs_length, HG, HG, 5, msg)
    # JAX's first band's loss before any step, on its own trajectory (seac.py:1110-1128)
    loss = _closure(ts, "minibatch_loss")
    return dict(msg=msg, jenv=jenv, env=env, cfg=cfg, dims=dims, jrunner=jrunner,
                jstates=jstates, jcarry=jcarry, jtraj=jtraj, jnew=jnew, jmetrics=jmetrics,
                offsets=offsets, scripted=scripted, sampled=sampled, jloss=loss,
                step=seac.build_seac_gru_train_step(env, dims, cfg, collect="plain"),
                runner=port_runner(jrunner, env))


def test_collect_with_jax_actions_is_exact(case):
    msg, step, runner = case["msg"], case["step"], case["runner"]
    jtraj = from_jax(case["jtraj"], msg)
    assert float(jtraj["reward"].abs().sum()) == 0 and not bool(jtraj["done"].any())
    actions = np.array(case["jtraj"].action)
    states, carry, traj = step.collect(runner.env_states, runner.params, 5, runner.carry,
                                       actions=torch.from_numpy(actions))
    assert set(traj) == set(jtraj)
    for k in ("obs", "action", "reward", "done") + (("bits",) if msg else ()):
        assert traj[k].dtype == jtraj[k].dtype and torch.equal(traj[k], jtraj[k]), k
    assert_fields_equal(states, case["jstates"], ALL_FIELDS)
    assert carry.dtype == torch.bfloat16
    np.testing.assert_array_equal(carry.float().numpy(),
                                  np.asarray(case["jcarry"].astype(jnp.float32)))
    err = float((traj["logp"] - jtraj["logp"]).abs().max())
    print(f"M={msg}: max |logp - JAX's| {err:.3g}")
    assert err <= LOGP_ATOL


def test_free_sampling_follows_jax(case):
    step, runner, msg = case["step"], case["runner"], case["msg"]
    states = to_port(case["scripted"])
    ours = [step.collect(states, runner.params, 50 + i, runner.carry)[2]
            for i in range(N_ROLLOUTS)]
    theirs = case["sampled"]

    def cat(trajs, k):
        return torch.cat([t[k] for t in trajs], dim=1)

    assert float(cat(ours, "reward").sum()) > 0 and float(cat(theirs, "reward").sum()) > 0
    for a in range(5):
        binomial_close(cat(ours, "action") == a, cat(theirs, "action") == a, f"move {a}")
    for m in range(msg):
        binomial_close(cat(ours, "bits")[..., m] == 1, cat(theirs, "bits")[..., m] == 1,
                       f"bit {m}")
    binomial_close(cat(ours, "reward").sum(-1) > 0, cat(theirs, "reward").sum(-1) > 0,
                   "reward")


@pytest.fixture(scope="module")
def update(case):
    """The port's step on JAX's own trajectory with JAX's env offsets, and
    the least bias-corrected |Adam mean| of each parameter over its steps."""
    step, runner = case["step"], case["runner"]
    states, carry = to_port(case["jstates"]), torch.from_numpy(
        np.array(case["jcarry"].astype(jnp.float32))).to(torch.bfloat16)
    traj = from_jax(case["jtraj"], case["msg"])
    optimizer_step, means = seac.seac_optimizer_step, []

    def recorded(cfg, params, grads, opt_state):
        params, opt_state = optimizer_step(cfg, params, grads, opt_state)
        means.append(opt_state.mu.abs() / (1 - ADAM_B1 ** opt_state.count))
        return params, opt_state

    step.rollout = lambda r: (states, carry, traj)  # this step only: JAX's collect
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(seac, "seac_optimizer_step", recorded)
            new, metrics = step(runner, case["offsets"])
    finally:
        del step.rollout
    return new, metrics, torch.stack(means).min(0).values


def test_update_on_jax_trajectory_matches_jax_train_step(case, update):
    new, metrics, least_mean = update
    jnew, cfg = case["jnew"], case["cfg"]
    assert_fields_equal(new.env_states, jnew.env_states, ALL_FIELDS)
    np.testing.assert_array_equal(new.carry.float().numpy(),
                                  np.asarray(jnew.carry.astype(jnp.float32)))
    p = cfg.epochs * cfg.minibatches
    want = seac_params_from_flax(jax.tree.map(np.asarray, jnew.params))
    diff = (new.params - want).abs()
    outside = diff > 0.05 * cfg.lr * p + 1e-3 * want.abs()
    print(f"M={case['msg']}: max |port - JAX| {float(diff.max()) / cfg.lr:.4g} lr, "
          f"{1 - float(outside.float().mean()):.6f} of the parameters within 0.05 lr P, the "
          f"rest's least Adam mean {float(least_mean[outside].max()) if outside.any() else 0:.3g}")
    assert 1 - float(outside.float().mean()) >= PARAM_SHARE
    assert bool((least_mean[outside] <= NEAR_ZERO_GRAD).all())
    assert new.opt_state.count == int(jnew.opt_state[1][0].count) == p
    assert new.update_idx == int(jnew.update_idx) == 1
    assert float((new.params - case["runner"].params).abs().max()) > 0
    assert set(metrics) == set(case["jmetrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(case["jmetrics"][k]), **METRIC_TOL,
                                   err_msg=k)


def _first_band(dataset, mb):
    band = [band_slice(x, 0, mb) for x in dataset]
    band[7] = dataset[7][:mb]  # the carry at the rollout's start: (B, N, Hg)
    return band


def test_first_epoch_own_ratio_is_as_close_to_one_as_jax(case):
    """Each side on its own collect's trajectory: the first band's own-stream
    ``approx_kl`` before any step."""
    msg, step, runner, cfg = case["msg"], case["step"], case["runner"], case["cfg"]
    mb = B // MINIBATCHES
    jtraj, jr = case["jtraj"], case["jrunner"]
    # JAX: the loss on its first band, with zero advantages (the ratio alone matters)
    zeros = jnp.zeros((T_LEN, mb, 2, 2), jnp.float32)
    jband = (jtraj.obs[:, :mb], jtraj.done[:, :mb], jtraj.action[:, :mb], jtraj.logp[:, :mb],
             zeros, zeros, zeros, jr.carry[:mb])
    jkl = float(compile_bf16_exact(case["jloss"], jr.params, jband)(jr.params, jband)[1]
                ["approx_kl"])
    # the port: its own collect's trajectory and its replay
    states, carry, traj = step.rollout(runner)
    z = torch.zeros((T_LEN, B, 2, 2))
    dataset = [traj["obs"], traj["done"], traj["action"], traj["logp"], z, z, z, runner.carry] \
        + ([traj["bits"]] if msg else [])
    _, metrics = seac.seac_gru_loss(cfg, case["dims"], runner.params, _first_band(dataset, mb))
    kl = float(metrics["approx_kl"])
    print(f"M={msg}: first band's own-stream approx_kl: port {kl:.3g}, JAX {jkl:.3g}")
    assert abs(kl) <= abs(jkl) + KL_SLACK


def _small_env(msg):
    return rware_tpu_torch.make(ENV, device="cpu", max_steps=6,
                                **({"msg_bits": msg} if msg else {}))


@pytest.mark.parametrize("msg", [0, 2])
def test_two_ranks_equal_the_per_shard_computation(msg):
    env = _small_env(msg)
    cfg = seac.SEACPPOConfig(n_envs=16, rollout_len=8, epochs=2, minibatches=2)
    runner0, dims = seac.init_seac_gru(env, cfg, 3, 16, 16)
    whole = seac.build_seac_gru_train_step(env, dims, cfg, collect="plain")
    offsets = [3, 6]
    env_states, carry, traj = whole.rollout(runner0)
    _, values, adv, targets = whole.advantages(runner0, env_states, traj)
    dataset = [traj["obs"], traj["done"], traj["action"], traj["logp"], values, adv, targets,
               runner0.carry[None]] + ([traj["bits"]] if msg else [])
    half, mb = cfg.n_envs // 2, cfg.n_envs // 2 // cfg.minibatches
    shards = [[x[:, r * half:(r + 1) * half] for x in dataset] for r in range(2)]
    params, opt_state, per_pass = runner0.params, runner0.opt_state, []
    for off in offsets:
        for m in range(cfg.minibatches):
            start = (m * mb - off) % half
            out = []
            for shard in shards:
                band = [band_slice(x, start, mb) for x in shard]
                band[7] = band[7][0]
                out.append(loss_grads(lambda q: seac.seac_gru_loss(cfg, dims, q, band), params))
            grads = (out[0][0] + out[1][0]) / 2
            per_pass.append({k: (out[0][1][k] + out[1][1][k]) / 2 for k in out[0][1]})
            params, opt_state = seac.seac_optimizer_step(cfg, params, grads, opt_state)
    want = mean_metrics(per_pass)

    def rank(mesh):
        runner, _ = seac.init_seac_gru(env, cfg, 3, 16, 16, mesh=mesh)
        step = seac.build_seac_gru_train_step(env, dims, cfg, mesh=mesh, collect="plain")
        return step.rollout(runner)[2], step(runner, offsets)

    for r, (rtraj, (new, metrics)) in enumerate(emulate_mesh(rank, 2, timeout=120)):
        for k, v in traj.items():
            assert torch.equal(rtraj[k], v[:, r * half:(r + 1) * half]), k
        assert torch.equal(new.params, params) and torch.equal(new.opt_state.mu, opt_state.mu)
        assert torch.equal(new.carry, carry[r * half:(r + 1) * half])
        for k, v in want.items():
            assert torch.equal(metrics[k], v), k
        assert int(metrics["episodes_done"]) == int(traj["done"].sum()) > 0


def test_resumed_run_equals_an_unbroken_one(tmp_path):
    env = _small_env(2)
    cfg = seac.SEACPPOConfig(n_envs=8, rollout_len=8, epochs=2, minibatches=2)

    def init(seed=4):  # each runner its own generator, advanced by its updates
        return seac.init_seac_gru(env, cfg, seed, 16, 16)

    runner, dims = init()
    step = seac.build_seac_gru_train_step(env, dims, cfg, collect="plain")
    unbroken = step(step(runner)[0])[0]
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, step(init()[0])[0])
    fresh = seac.build_seac_gru_train_step(env, dims, cfg, collect="plain")
    assert_runners_equal(fresh(ckpt.restore(template=init(9)[0]))[0], unbroken)


def test_plain_learner_launches_no_kernel(case):
    assert not [k for k, v in vars(case["step"]).items() if hasattr(v, "launches")]
    with pytest.raises(ValueError, match="no deterministic mode"):
        seac.build_seac_gru_train_step(case["env"], case["dims"], case["cfg"],
                                       deterministic_collect=True, collect="plain")


@pytest.mark.parametrize("msg", [0, 2])
def test_train_plain_and_evaluate_entry_points(tmp_path, msg):
    out = train.main(["--algo", "seac-ppo", "--net", "gru", "--collect", "plain", "--device",
                      "cpu", "--n-envs", "16", "--rollout-len", "8", "--updates", "2",
                      "--log-every", "1", "--checkpoint-dir", str(tmp_path)]
                     + ["--msg-bits", str(msg)] * bool(msg))
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl", "reward_per_env", "episodes_done"):
        assert np.isfinite(out[k]), k
    ckpt = torch.load(str(tmp_path / "policy.pt"))
    assert ckpt["net"] == "gru" and ckpt["per_agent"] == 2 and ckpt["msg_bits"] == msg
    stats = evaluate.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path), "--episodes",
                           "4", "--max-steps", "30"])
    assert stats["episodes"] == 4 and np.isfinite(stats["mean_return"])
