"""SEAC A2C's pieces on the CPU: the port's ``init_seac`` and ``seac_a2c_loss``
against ``rware_tpu.models.seac`` (``init_seac``, ``loss_fn``), the stacked
converters on ``init_seac``'s tree, the port of
``test_lambda_zero_disables_sharing``, and the ``train --algo seac`` /
``evaluate`` entry points.  The updates on JAX's own trajectories are in
``tests/test_torch_seac_a2c_train.py``.

Inputs are made with numpy from a seed; parameters go through
``rware_tpu_torch.convert`` from JAX's ``init_seac`` with the biases moved off
zero.  The JAX side is compiled without XLA's excess precision
(``tests/torch_ref.jit_bf16_exact``), so both sides round to bf16 at the same
places and differ by float32 summation order and a rare flipped bf16 rounding
of a hidden unit.

Tolerances.  The loss and its metrics within rtol 2e-2, atol 2e-3, and the
gradients within 5% of each leaf's largest |value| (``GRAD_TOL``), as
``tests/test_torch_seac.py`` holds SEAC-PPO's loss; the converters and
``seac_lambda`` 0's independence of the other agent's rewards bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.models import seac as jax_seac
from rware_tpu_torch import convert, evaluate, train
from rware_tpu_torch.models import seac
from rware_tpu_torch.models.networks import BlockDims
from rware_tpu_torch.models.ppo import loss_grads
from tests.torch_ref import jit_bf16_exact

torch.set_num_threads(1)

N, L = 2, 71
METRIC_TOL = dict(rtol=2e-2, atol=2e-3)
GRAD_TOL = 0.05
LOSS_KEYS = ("pg_loss", "v_loss", "entropy", "mean_is_weight")


def biased(params, seed, scale=0.1):
    """``params`` (numpy leaves) with every bias moved off zero."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "bias" else np.asarray(x), params)


def closure_fn(step, name):
    """The function ``name`` of ``build_seac_train_step``'s closure."""
    return step.__closure__[step.__code__.co_freevars.index(name)].cell_contents


def assert_stack_close(got, want_tree, dims, frac, what=""):
    """Each leaf of the (N, P) stack ``got`` within ``frac * max |want leaf|``."""
    got = jax.tree_util.tree_flatten_with_path(convert.seac_params_to_flax(got, dims))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want_tree))[0])
    assert len(got) == len(want) == 8 + 2 * bool(dims.msg_bits)
    for path, g in got:
        w = want[path]
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, atol=frac * max(np.abs(w).max(), 1e-6),
                                   err_msg=f"{what} {path}")


@pytest.fixture(scope="module", params=[0, 2], ids=["M0", "M2"])
def jax_a2c(request):
    """(jenv, model, tx, params (biases off zero), dims) of JAX's
    ``init_seac`` on tiny-2ag with ``msg_bits`` M."""
    m = request.param
    jenv = rware_tpu.make("rware-tiny-2ag-v2", msg_bits=m)
    runner, model, tx = jax_seac.init_seac(jenv, jax_seac.SEACConfig(n_envs=4),
                                           jax.random.key(0))
    dims = BlockDims(jenv.config.policy_obs_length, 128, 128, 5, m)
    return jenv, model, tx, biased(runner.params, 1), dims


def make_rollout(seed, m, l_obs=L, t_len=4, b=96):
    """A numpy rollout (obs (T, B, N, L), action (T, B, N[, 1 + M]), behaviour
    logp, reward (T, B, N), done (T, B)) and the observations after it."""
    rng = np.random.default_rng(seed)
    action = rng.integers(0, 5, (t_len, b, N)).astype(np.int32)
    if m:
        action = np.concatenate([action[..., None],
                                 rng.integers(0, 2, (t_len, b, N, m)).astype(np.int32)], -1)
    return (
        rng.standard_normal((t_len, b, N, l_obs)).astype(np.float32),
        action,
        (rng.standard_normal((t_len, b, N)) * 0.1 - 1.6 - 0.7 * m).astype(np.float32),
        (rng.random((t_len, b, N)) < 0.1).astype(np.float32),
        rng.random((t_len, b)) < 0.2,
    ), rng.standard_normal((b, N, l_obs)).astype(np.float32)


def port_traj(traj, m):
    """The port's trajectory dict of a JAX-layout rollout (numpy or JAX
    arrays): the move and the bits apart."""
    obs, action, logp, reward, done = (np.array(x) for x in traj)
    out = {"obs": torch.from_numpy(obs), "logp": torch.from_numpy(logp),
           "reward": torch.from_numpy(reward), "done": torch.from_numpy(done)}
    out["action"] = torch.from_numpy(action[..., 0] if m else action)
    if m:
        out["bits"] = torch.from_numpy(action[..., 1:])
    return out


@pytest.mark.parametrize("seac_lambda", [0.0, 1.0])
def test_seac_a2c_loss_matches_jax(jax_a2c, seac_lambda):
    """The loss, every metric and the gradients against
    ``jax.value_and_grad`` of JAX's ``loss_fn`` (``seac.py:170-231``), taken
    from ``build_seac_train_step``'s closure."""
    jenv, model, tx, params, dims = jax_a2c
    m = dims.msg_bits
    jcfg = jax_seac.SEACConfig(seac_lambda=seac_lambda)
    loss = closure_fn(jax_seac.build_seac_train_step(jenv, model, tx, jcfg), "loss_fn")
    traj, last_obs = make_rollout(5 + m, m, dims.obs_len)
    (jtotal, jm), jg = jit_bf16_exact(
        jax.value_and_grad(lambda p, tr, lo: loss(p, jax_seac.SEACTransition(*tr), lo),
                           has_aux=True),
        params, tuple(map(jnp.asarray, traj)), jnp.asarray(last_obs))
    cfg = seac.SEACConfig(seac_lambda=seac_lambda)
    theta = convert.seac_params_from_flax(params)
    totals = []

    def port_loss(p):
        total, metrics = seac.seac_a2c_loss(cfg, dims, p, port_traj(traj, m),
                                            torch.from_numpy(last_obs))
        totals.append(float(total.detach()))
        return total, metrics

    grads, metrics = loss_grads(port_loss, theta)
    assert set(metrics) == set(jm) == set(LOSS_KEYS)
    np.testing.assert_allclose(totals[0], float(jtotal), **METRIC_TOL)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), err_msg=k, **METRIC_TOL)
    if seac_lambda == 0.0:
        assert float(metrics["mean_is_weight"]) > 0  # reported, though it weights nothing
    if m:
        assert float(metrics["entropy"]) > np.log(5)  # the joint entropy: move and bits
    assert_stack_close(grads, jg, dims, GRAD_TOL)


def test_lambda_zero_disables_sharing():
    """With seac_lambda 0 the cross terms vanish: agent i's gradient depends
    only on agent i's own experience, so changing agent 1's rewards leaves
    agent 0's gradient as it was, bit for bit (``tests/test_seac.py:40``);
    with seac_lambda 1 it moves agent 0's too.  A train step at 0 runs."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu")
    runner, dims = seac.init_seac(env, seac.SEACConfig(n_envs=8, rollout_len=4), seed=2)
    traj, last_obs = make_rollout(9, 0, b=32)
    traj = port_traj(traj, 0)
    moved = dict(traj, reward=traj["reward"].clone())
    moved["reward"][..., 1] += 1.0

    def grads(cfg, tr):
        return loss_grads(lambda p: seac.seac_a2c_loss(cfg, dims, p, tr, torch.from_numpy(
            last_obs)), runner.params)[0]

    zero = seac.SEACConfig(seac_lambda=0.0)
    g, g_moved = grads(zero, traj), grads(zero, moved)
    assert torch.equal(g[0], g_moved[0])
    assert not torch.equal(g[1], g_moved[1])
    one = seac.SEACConfig(seac_lambda=1.0)
    assert not torch.equal(grads(one, traj)[0], grads(one, moved)[0])
    cfg = seac.SEACConfig(n_envs=8, rollout_len=4, seac_lambda=0.0)
    new, metrics = seac.build_seac_train_step(env, dims, cfg)(runner)
    assert new.update_idx == 1 and np.isfinite(float(metrics["pg_loss"]))


def test_init_draws_each_agent_its_own_flax_default_init():
    """``init_seac``: N independent flax-default inits stacked into (N, P),
    the optimizer state over the stack, a fresh env batch; ``init_seac_ppo``
    takes the same init (``seac.py:296-307``)."""
    env = rware_tpu_torch.make("rware-small-4ag-v2", device="cpu")
    cfg = seac.SEACConfig(n_envs=8)
    assert cfg == seac.SEACConfig(8, 5, 0.99, 0.95, 1.0, 0.5, 0.01, 3e-4, 0.5)
    runner, dims = seac.init_seac(env, cfg, seed=3)
    assert dims == BlockDims(L, 128, 128, 5) and runner.params.shape == (4, dims.n_params)
    assert runner.opt_state.count == 0 and float(runner.opt_state.mu.abs().max()) == 0.0
    assert runner.env_states.batch_size == 8 and runner.obs.shape == (8, 4, L)
    ppo, _ = seac.init_seac_ppo(env, seac.SEACPPOConfig(n_envs=8, rollout_len=4), seed=3)
    assert torch.equal(ppo.params, runner.params)
    for i in range(4):
        w0, b0, w1, b1, wc, bc = dims.split(runner.params[i])
        for j in range(i):
            assert not torch.equal(w0, dims.split(runner.params[j])[0])  # independent draws
        assert float(b0.abs().max()) == float(b1.abs().max()) == float(bc.abs().max()) == 0.0
        for w in (w0, w1, wc):  # LeCun normal, truncated at two deviations
            assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.1
    msg_env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu", msg_bits=2)
    _, mdims = seac.init_seac(msg_env, cfg, seed=3)
    assert mdims.msg_bits == 2 and mdims.heads == 5 + 1 + 2


def test_converters_take_jax_init_seac_unchanged(jax_a2c):
    """The stacked converters carry ``init_seac``'s params and optax state
    across and back bit for bit (M=0 and M=2)."""
    _, _, tx, params, dims = jax_a2c
    theta = convert.seac_params_from_flax(params)
    assert theta.shape == (N, dims.n_params)
    back = convert.seac_params_to_flax(theta, dims)
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                              jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
    opt = jax.tree.map(np.asarray, tx.update(grads, tx.init(params), params)[1])
    state = convert.seac_opt_state_from_optax(opt)
    assert state.count == 1 and state.nu.shape == theta.shape
    again = convert.seac_opt_state_to_optax(state, dims, opt)
    for name in ("mu", "nu"):
        for (p, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(getattr(again[1][0], name))[0],
                jax.tree_util.tree_flatten_with_path(getattr(opt[1][0], name))[0]):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {p}")
    policies = seac.seac_policies_of(dims, theta)
    assert len(policies) == N and all(p.msg_bits == dims.msg_bits for p in policies)


def test_train_evaluate_and_resume_seac_a2c(tmp_path, capsys):
    common = ["--algo", "seac", "--device", "cpu", "--n-envs", "16", "--log-every", "1"]
    out = train.main(common + ["--updates", "3", "--checkpoint-dir", str(tmp_path / "a")])
    assert "updates x 80 env-steps" in capsys.readouterr().out  # T=5 by default
    for k in (*LOSS_KEYS, "reward_per_env", "episodes_done", "env_steps_per_s"):
        assert np.isfinite(out[k]), k
    ckpt = torch.load(str(tmp_path / "a" / "policy.pt"))
    assert ckpt["net"] == "mlp" and ckpt["per_agent"] == 2 and ckpt["updates"] == 3
    env_id, policies = train.load_policy(str(tmp_path / "a" / "policy.pt"))
    assert env_id == "rware-tiny-2ag-v2" and isinstance(policies, torch.nn.ModuleList)
    stats = evaluate.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path / "a"),
                           "--episodes", "8", "--max-steps", "30"])
    assert stats["episodes"] == 8 and np.isfinite(stats["mean_return"])
    # a run broken after 2 updates and resumed equals the unbroken one
    b = ["--checkpoint-dir", str(tmp_path / "b"), "--checkpoint-every", "1"]
    train.main(common + ["--updates", "2"] + b)
    train.main(common + ["--updates", "3", "--resume"] + b)
    assert "resumed from update 2" in capsys.readouterr().out
    resumed = torch.load(str(tmp_path / "b" / "policy.pt"))["state_dict"]
    for k, v in ckpt["state_dict"].items():
        assert torch.equal(v, resumed[k]), k
    train.main(common + ["--updates", "1", "--rollout-len", "3"])
    assert "updates x 48 env-steps" in capsys.readouterr().out


def test_train_seac_a2c_msg_bits_and_refusals(tmp_path):
    out = train.main(["--algo", "seac", "--msg-bits", "2", "--device", "cpu", "--n-envs", "16",
                      "--updates", "2", "--collect", "plain", "--checkpoint-dir", str(tmp_path)])
    assert out["entropy"] > np.log(5)  # the joint entropy: move and two bits
    ckpt = torch.load(str(tmp_path / "policy.pt"))
    assert ckpt["per_agent"] == 2 and ckpt["msg_bits"] == 2
    with pytest.raises(ValueError, match="MLP policies only"):
        train.main(["--algo", "seac", "--net", "gru", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="no such learner"):
        train.main(["--algo", "seac", "--fused-critic-phase", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--algo", "seac", "--updates", "1"])
