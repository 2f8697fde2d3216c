"""MAPPO on JAX's XLA collect, on the CPU: the port's ``train --collect plain``
learner (``mappo.build_mappo_train_step(collect="plain")``) against the JAX
package's ``build_mappo_train_step(collect_mode="xla")``, without and with two
message bits (tiny-2ag, B=128, T=8, E=2, M=2, hidden (128, 128); the actor's
and the critic's biases made nonzero, as training moves them).

* Collect, fixed actions: JAX's own XLA collect (the ``collect`` closure of its
  train step, with the train step's key) hands its actions to the port's plain
  collect from the same states and parameters.  No episode ends and no shelf
  is delivered inside the window, so no draw of either side enters: obs,
  rewards, done and the env state are equal bit for bit, and the joint
  ``logp`` is within 1e-5.
* Collect, free sampling: from a batch of scripted states (agent 0 one step
  from the goal with a requested shelf), the port's Philox draws against JAX's
  keys: each move's and each bit's frequency and the share of steps with a
  reward within 5 sigma of a binomial difference (``tests/test_torch_policy.py``
  sets the bound for one side).
* Gradient rounding: on JAX's first window, JAX's gradient is bf16-exact in
  both parts' hidden kernels (``mappo.TRUNK_CAST_BLOCKS``) and in no other
  block, and the port's is within 5% of each block's largest.
* Update: the port's critic values, GAE and E x M passes on JAX's own
  trajectory with JAX's window starts, against JAX's whole ``train_step``:
  env states equal, parameters within 0.05 * lr * P (rtol 1e-3), metrics within
  rtol 2e-2, atol 2e-3.
* Mesh: two emulated ranks (``testing.emulate_mesh``) equal the per-shard
  computation bit for bit: each rank collects its rows of the global collect,
  and each pass is the mean of the shards' window gradients, each shard's
  advantages normalised over its own rows, as ``shard_map`` does.
* Resume, and ``train --collect plain`` / ``evaluate``.
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
from rware_tpu.ops.pallas_rollout import LANE
from rware_tpu.ops.pallas_update import phase_time_block as jax_time_block
from rware_tpu.testing import DOWN, UP
from rware_tpu.testing import make_state as jax_make_state
from rware_tpu_torch import evaluate, train
from rware_tpu_torch.checkpoint import Checkpointer
from rware_tpu_torch.convert import mappo_opt_state_from_optax, mappo_params_from_flax
from rware_tpu_torch.models import ippo, mappo
from rware_tpu_torch.models.networks import BlockDims, CriticDims
from rware_tpu_torch.testing import emulate_mesh
from tests.test_torch_checkpoint import assert_runners_equal
from tests.torch_ref import ALL_FIELDS, assert_fields_equal, compile_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

ENV = "rware-tiny-2ag-v2"
B, T_LEN, EPOCHS, MINIBATCHES = 128, 8, 2, 2
PARTS = ("actor", "critic")
LOGP_ATOL = 1e-5
SIGMAS = 5.0
GRAD_TOL = 0.05  # of each block's largest magnitude, as tests/test_torch_ippo.py's
METRIC_TOL = dict(rtol=2e-2, atol=2e-3)


def _closure(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def from_native(traj):
    """The port's (T, B, N, ...) trajectory of JAX's native one (T, ..., RB,
    LANE; ``mappo.py:326-345``)."""
    t, n = traj["action"].shape[:2]

    def rows(x):  # (T, K, RB, LANE) -> (T, B, K)
        x = np.asarray(x)
        return x.reshape(t, x.shape[1], -1).transpose(0, 2, 1)

    obs = np.asarray(traj["obs"], dtype=np.float32)  # (T, L, N, RB, LANE)
    out = {"obs": torch.from_numpy(obs.reshape(t, obs.shape[1], n, -1).transpose(0, 3, 2, 1)
                                   .copy()).to(torch.bfloat16),
           "action": torch.from_numpy(rows(traj["action"]).copy()),
           "logp": torch.from_numpy(rows(traj["logp"]).copy()),
           "reward": torch.from_numpy(rows(traj["reward"]).copy()),
           "done": torch.from_numpy(rows(traj["done"])[..., 0].astype(bool))}
    if "bits" in traj:
        bits = rows(traj["bits"])  # (T, B, N*M), agent-major
        out["bits"] = torch.from_numpy(bits.reshape(t, bits.shape[1], n, -1).copy())
    return out


def engine_actions(traj):
    """(T, B, N) moves, or (T, B, N, 1 + M) with the bits after the move."""
    if "bits" not in traj:
        return traj["action"]
    return torch.cat([traj["action"][..., None], traj["bits"]], dim=-1)


def _port_runner(jrunner, env):
    states = to_port(jrunner.env_states)
    params = mappo_params_from_flax(jax.tree.map(np.asarray, jrunner.params))
    return ippo.RunnerState(
        params=params,
        opt_state=mappo_opt_state_from_optax(jax.tree.map(np.asarray, jrunner.opt_state)),
        env_states=states, obs=ippo.policy_obs_fn(env)(states), generator=torch.Generator(),
        update_idx=0, seed=0)


def _dims(env):
    l_obs, n, m = env.config.policy_obs_length, env.n_agents, env.config.msg_bits
    return BlockDims(l_obs, 128, 128, 5, m), CriticDims(n, l_obs, 128, 128)


def scripted_batch(jenv):
    """B copies of a state where agent 0 faces the goal one step away,
    carrying the first requested shelf (each copy with its own key)."""
    def one(seed):
        return jax_make_state(jenv.config, [(4, 9, DOWN), (0, 0, UP)], carrying=[0, -1],
                              queue=[0, 1], seed=seed)
    return jax.vmap(one)(jnp.arange(B))


@pytest.fixture(scope="module", params=[0, 2], ids=["M0", "M2"])
def case(request):
    msg = request.param
    jenv, env = make_pair(rware_tpu.make(ENV, msg_bits=msg).config)
    kw = dict(n_envs=B, rollout_len=T_LEN, epochs=EPOCHS, minibatches=MINIBATCHES)
    jcfg, cfg = JaxConfig(**kw), ippo.IPPOConfig(**kw)
    jrunner, actor, critic, tx = jax_mappo.init_mappo_runner(jenv, jcfg, jax.random.key(3))
    rng = np.random.default_rng(msg)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + (0.02 * rng.standard_normal(x.shape)).astype(np.float32)
        if path[-1].key == "bias" else np.asarray(x), jrunner.params)
    jrunner = jrunner.replace(params=params, opt_state=tx.init(params))
    ts = jax_mappo.build_mappo_train_step(jenv, actor, critic, tx, jcfg, collect_mode="xla")
    collect = compile_bf16_exact(_closure(ts, "collect"), jrunner,
                                 jax.random.split(jrunner.key, 3)[2])
    _, k_perm, k_roll = jax.random.split(jrunner.key, 3)
    jstates, jtraj = collect(jrunner, k_roll)
    jnew, jmetrics = compile_bf16_exact(ts, jrunner)(jrunner)
    starts = jax_native.phase_window_starts(jcfg, T_LEN, jax_time_block(T_LEN // MINIBATCHES),
                                            k_perm)
    # JAX's collect from the scripted states, for the sampling laws
    scripted = scripted_batch(jenv)
    sampled = collect(jrunner.replace(env_states=scripted,
                                      obs=jax.vmap(jax_ippo.policy_obs_fn(jenv))(scripted)),
                      jax.random.key(11))[1]
    dims, cdims = _dims(env)
    return dict(msg=msg, jenv=jenv, env=env, cfg=cfg, jrunner=jrunner, jstates=jstates,
                jtraj=jtraj, jnew=jnew, jmetrics=jmetrics, jcfg=jcfg,
                starts=torch.from_numpy(np.array(starts)).to(torch.int64),
                scripted=scripted, sampled=from_native(sampled), dims=dims, cdims=cdims,
                step=mappo.build_mappo_train_step(env, dims, cdims, cfg, collect="plain"),
                runner=_port_runner(jrunner, env))


def test_collect_with_jax_actions_is_exact(case):
    jtraj = from_native(case["jtraj"])
    assert float(jtraj["reward"].abs().sum()) == 0 and not bool(jtraj["done"].any())
    step, runner = case["step"], case["runner"]
    states, traj = step.collect(runner.env_states, runner.params["actor"], 5,
                                actions=engine_actions(jtraj))
    assert set(traj) == set(jtraj)
    for k in ("obs", "action", "reward", "done") + (("bits",) if case["msg"] else ()):
        assert traj[k].dtype == jtraj[k].dtype and torch.equal(traj[k], jtraj[k]), k
    assert_fields_equal(states, case["jstates"], ALL_FIELDS)
    err = float((traj["logp"] - jtraj["logp"]).abs().max())
    print(f"M={case['msg']}: max |logp - JAX's| {err:.3g}")
    assert err <= LOGP_ATOL


def binomial_close(a, b, what):
    """Frequencies a and b of two sides' n samples each (a 0/1 tensor's
    mean), within SIGMAS of their difference's binomial deviation."""
    p = (a.double().mean() + b.double().mean()) / 2
    sigma = float(torch.sqrt(p * (1 - p) * 2 / a.numel()))
    gap = float((a.double().mean() - b.double().mean()).abs())
    assert gap <= SIGMAS * sigma + 1e-12, (what, gap, sigma)


def test_free_sampling_follows_jax(case):
    step, runner, jtraj = case["step"], case["runner"], case["sampled"]
    states = to_port(case["scripted"])
    _, traj = step.collect(states, runner.params["actor"], 17)
    assert float(jtraj["reward"].sum()) > 0 and float(traj["reward"].sum()) > 0
    for a in range(5):
        binomial_close(traj["action"] == a, jtraj["action"] == a, f"move {a}")
    if case["msg"]:
        for m in range(case["msg"]):
            binomial_close(traj["bits"][..., m] == 1, jtraj["bits"][..., m] == 1, f"bit {m}")
    binomial_close(traj["reward"].sum(-1) > 0, jtraj["reward"].sum(-1) > 0, "reward")


def test_gradient_rounding_matches_jax(case):
    """JAX's first-window gradient is bf16-exact in the hidden kernels of
    both parts and nowhere else; the port's within GRAD_TOL of it."""
    rng = np.random.default_rng(1)
    n, t_mb = case["env"].n_agents, T_LEN // MINIBATCHES
    jtraj = case["jtraj"]
    shape = (t_mb, n, B // LANE, LANE)
    values = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    adv = rng.standard_normal(shape).astype(np.float32)
    batch = (jtraj["obs"][:t_mb], jtraj["action"][:t_mb], jtraj["logp"][:t_mb], values, adv,
             adv + values) + ((jtraj["bits"][:t_mb],) if case["msg"] else ())
    params = case["jrunner"].params
    jgrads = compile_bf16_exact(
        lambda p, b: jax.grad(lambda q: jax_mappo.mappo_loss_native(case["jcfg"], q, b)[0])(p),
        params, batch)(params, batch)
    want = mappo_params_from_flax(jax.tree.map(np.asarray, jgrads))
    port = from_native(dict(jtraj, obs=jtraj["obs"][:t_mb], action=jtraj["action"][:t_mb],
                            logp=jtraj["logp"][:t_mb], reward=jtraj["reward"][:t_mb],
                            done=jtraj["done"][:t_mb],
                            **({"bits": jtraj["bits"][:t_mb]} if case["msg"] else {})))

    def common(x):  # (T, N, RB, LANE) -> (T, B, N)
        return torch.from_numpy(x.reshape(t_mb, n, B).transpose(0, 2, 1).copy())

    dataset = (port["obs"], port["action"], port["logp"], common(values), common(adv),
               common(adv + values)) + ((port["bits"],) if case["msg"] else ())
    step = case["step"]
    got, _ = step.grads(case["runner"].params, dataset, 0)
    for part, dims in zip(PARTS, (step.dims, step.cdims)):
        blocks = dims.split(want[part])
        exact = [i for i, w in enumerate(blocks) if torch.equal(w, w.bfloat16().float())]
        assert tuple(exact) == mappo.TRUNK_CAST_BLOCKS, (part, exact)
        for i, (g, w) in enumerate(zip(dims.split(got[part]), blocks)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_TOL * float(w.abs().max()),
                                       err_msg=f"{part} block {i}")


@pytest.fixture(scope="module")
def update(case):
    """The port's step on JAX's own trajectory with JAX's window starts."""
    step, runner = case["step"], case["runner"]
    env_states = to_port(case["jstates"])
    traj = from_native(case["jtraj"])
    step.rollout = lambda r: (env_states, traj)  # this step only: JAX's collect
    try:
        return step(runner, case["starts"])
    finally:
        del step.rollout


def test_update_on_jax_trajectory_matches_jax_train_step(case, update):
    new, metrics = update
    jnew, jmetrics, cfg = case["jnew"], case["jmetrics"], case["cfg"]
    assert_fields_equal(new.env_states, jnew.env_states, ALL_FIELDS)
    np.testing.assert_array_equal(new.obs.numpy(), np.asarray(jnew.obs))
    p = cfg.epochs * cfg.minibatches
    want = mappo_params_from_flax(jax.tree.map(np.asarray, jnew.params))
    for part in PARTS:
        diff = float((new.params[part] - want[part]).abs().max())
        print(f"M={case['msg']} {part}: max |port - JAX| {diff / cfg.lr:.4g} lr")
        np.testing.assert_allclose(new.params[part].numpy(), want[part].numpy(),
                                   atol=0.05 * cfg.lr * p, rtol=1e-3, err_msg=part)
        assert new.opt_state[part].count == int(jnew.opt_state[part][1][0].count) == p
        moved = (new.params[part] - case["runner"].params[part]).abs()
        assert float(moved.max()) > 0
    assert new.update_idx == int(jnew.update_idx) == 1
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), **METRIC_TOL, err_msg=k)


def test_plain_learner_launches_no_kernel(case):
    step = case["step"]
    assert not [k for k, v in vars(step).items() if hasattr(v, "launches")]
    with pytest.raises(ValueError, match="no whole-MAPPO-phase kernel"):
        mappo.build_mappo_train_step(case["env"], case["dims"], case["cdims"], case["cfg"],
                                     fused_critic_phase=True, collect="plain")


def _small(msg):
    """A CPU env whose episodes end inside an update, and a small config."""
    env = rware_tpu_torch.make(ENV, device="cpu", max_steps=6,
                               **({"msg_bits": msg} if msg else {}))
    return env, ippo.IPPOConfig(n_envs=16, rollout_len=8, epochs=2, minibatches=2)


@pytest.mark.parametrize("msg", [0, 2])
def test_two_ranks_equal_the_per_shard_computation(msg):
    env, cfg = _small(msg)
    runner0, dims, cdims = mappo.init_mappo_runner(env, cfg, 2, (32, 32), (32, 32))
    whole = mappo.build_mappo_train_step(env, dims, cdims, cfg, collect="plain")
    starts = torch.tensor([4, 6, 0, 2])
    env_states, traj = whole.rollout(runner0)
    values = whole.values(runner0, traj)
    _, adv, targets = whole.advantages(runner0, env_states, traj, values)
    dataset = (traj["obs"], traj["action"], traj["logp"], values, adv, targets) \
        + ((traj["bits"],) if msg else ())
    params, opt_state, per_pass = runner0.params, runner0.opt_state, []
    half = cfg.n_envs // 2
    for start in starts.tolist():
        shards = [whole.grads(params, tuple(x[:, r * half:(r + 1) * half] for x in dataset),
                              start) for r in range(2)]
        grads = {k: (shards[0][0][k] + shards[1][0][k]) / 2 for k in PARTS}
        per_pass.append({k: (shards[0][1][k] + shards[1][1][k]) / 2 for k in shards[0][1]})
        params, opt_state = mappo.mappo_optimizer_step(cfg, params, grads, opt_state)
    want = ippo.mean_metrics(per_pass)

    def rank(mesh):
        runner, _, _ = mappo.init_mappo_runner(env, cfg, 2, (32, 32), (32, 32), mesh=mesh)
        step = mappo.build_mappo_train_step(env, dims, cdims, cfg, mesh=mesh, collect="plain")
        return step.rollout(runner)[1], step(runner, starts)

    for r, (rtraj, (new, metrics)) in enumerate(emulate_mesh(rank, 2, timeout=120)):
        for k, v in traj.items():
            assert torch.equal(rtraj[k], v[:, r * half:(r + 1) * half]), k
        for part in PARTS:
            assert torch.equal(new.params[part], params[part]), part
            assert torch.equal(new.opt_state[part].mu, opt_state[part].mu)
        for k, v in want.items():
            assert torch.equal(metrics[k], v), k
        assert float(metrics["reward_per_env"]) == float(traj["reward"].sum()) / cfg.n_envs
        assert int(metrics["episodes_done"]) == int(traj["done"].sum()) > 0


def test_resumed_run_equals_an_unbroken_one(tmp_path):
    env, cfg = _small(2)

    def init(seed=4):  # each runner its own generator, advanced by its updates
        return mappo.init_mappo_runner(env, cfg, seed, (32, 32), (32, 32))

    runner, dims, cdims = init()
    step = mappo.build_mappo_train_step(env, dims, cdims, cfg, collect="plain")
    unbroken = step(step(runner)[0])[0]
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, step(init()[0])[0])
    template = init(9)[0]
    fresh = mappo.build_mappo_train_step(env, dims, cdims, cfg, collect="plain")
    assert_runners_equal(fresh(ckpt.restore(template=template))[0], unbroken)


@pytest.mark.parametrize("msg", [0, 2])
def test_train_plain_and_evaluate_entry_points(tmp_path, msg):
    out = train.main(["--algo", "mappo", "--collect", "plain", "--device", "cpu", "--n-envs",
                      "32", "--rollout-len", "8", "--updates", "2", "--log-every", "1",
                      "--checkpoint-dir", str(tmp_path)] + ["--msg-bits", str(msg)] * bool(msg))
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl", "reward_per_env", "episodes_done"):
        assert np.isfinite(out[k]), k
    assert out["entropy"] > (np.log(5) if msg else 1.0)
    ckpt = torch.load(str(tmp_path / "policy.pt"))
    assert ckpt["msg_bits"] == msg and "critic" in ckpt and ckpt["updates"] == 2
    stats = evaluate.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path), "--episodes",
                           "4", "--max-steps", "30"])
    assert stats["episodes"] == 4 and np.isfinite(stats["mean_return"])
