"""The port's SEAC-PPO pieces against the JAX package: the per-agent init, the
stacked converters and the optax-state converter, the cross values and cross
GAE, the flax-rounded minibatch loss and its gradients, and the clip + Adam
step over the whole stack.

Inputs are made with numpy from a seed; parameters and optimizer state go
through ``rware_tpu_torch.convert`` from one JAX ``init_seac_ppo``.  The JAX
side is compiled without XLA's excess precision
(``tests/torch_ref.jit_bf16_exact``), so both round to bf16 at the same
places and differ by float32 summation order.  Tolerances: metrics within
rtol 2e-2, atol 2e-3 and gradients within 5% of each leaf's largest |value|
(``test_pallas_update.py:51-66``, as for IPPO's loss); the optimizer within
rtol 1e-6; values within 2e-3 (a flipped bf16 rounding of a hidden unit times
a head weight) and equal to 1e-5 on 98% of them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.models import IPPOConfig as JaxConfig
from rware_tpu.models import ippo as jax_ippo
from rware_tpu.models import seac as jax_seac
from rware_tpu.models.ippo_pallas import _native_forward
from rware_tpu_torch import convert
from rware_tpu_torch.models import seac
from rware_tpu_torch.models.networks import BlockDims
from rware_tpu_torch.models.ppo import METRIC_KEYS, loss_grads
from tests.torch_ref import jit_bf16_exact

torch.set_num_threads(1)

N, L, M = 2, 71, 512
DIMS = BlockDims(L, 128, 128, 5)
METRIC_TOL = dict(rtol=2e-2, atol=2e-3)
GRAD_TOL = 0.05


@pytest.fixture(scope="module")
def jax_init():
    """JAX's SEAC-PPO runner on tiny-2ag, biases moved off zero."""
    jenv = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = jax_seac.SEACPPOConfig(n_envs=8, rollout_len=4)
    runner, model, tx = jax_seac.init_seac_ppo(jenv, cfg, jax.random.key(0))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "bias" else np.asarray(x), runner.params)
    return jenv, model, tx, params


def jax_minibatch_loss(jenv, model, tx, cfg):
    """``minibatch_loss`` of ``build_seac_ppo_train_step`` (``seac.py:443-480``),
    taken from the plain train step's closure."""
    step = jax_seac.build_seac_ppo_train_step(jenv, model, tx, cfg, update_mode="xla")
    return step.__closure__[step.__code__.co_freevars.index("minibatch_loss")].cell_contents


def make_flat_batch(seed):
    """(obs (M, N, L), action, behaviour logp (M, N), old value, advantage,
    target (M, N_i, N_j)) as numpy."""
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((M, N, L)).astype(np.float32),
        rng.integers(0, 5, (M, N)).astype(np.int32),
        (rng.standard_normal((M, N)) * 0.1 - 1.6).astype(np.float32),
        *(rng.standard_normal((M, N, N)).astype(np.float32) for _ in range(3)),
    )


def assert_stack_close(got, want_tree, frac):
    """Each leaf of the (N, P) stack ``got`` within ``frac * max |want leaf|``."""
    got = jax.tree_util.tree_flatten_with_path(convert.seac_params_to_flax(got, DIMS))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want_tree))[0])
    assert len(got) == len(want) == 8
    for path, g in got:
        w = want[path]
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, atol=frac * max(np.abs(w).max(), 1e-6),
                                   err_msg=str(path))


def assert_values_close(got, want):
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert (diff < 1e-5).mean() > 0.98, (diff < 1e-5).mean()
    assert diff.max() < 2e-3, diff.max()


def test_init_draws_each_agent_its_own_flax_default_init():
    env = rware_tpu_torch.make("rware-small-4ag-v2", device="cpu")
    cfg = seac.SEACPPOConfig(n_envs=8, rollout_len=4)
    runner, dims = seac.init_seac_ppo(env, cfg, seed=3)
    assert dims == DIMS and runner.params.shape == (4, DIMS.n_params)
    assert runner.opt_state.count == 0 and runner.opt_state.mu.shape == runner.params.shape
    assert float(runner.opt_state.nu.abs().max()) == 0.0
    again, _ = seac.init_seac_ppo(env, cfg, seed=3)
    other, _ = seac.init_seac_ppo(env, cfg, seed=4)
    assert torch.equal(again.params, runner.params)
    assert not torch.equal(other.params, runner.params)
    for i in range(4):
        w0, b0, w1, b1, wc, bc = DIMS.split(runner.params[i])
        for j in range(i):
            assert not torch.equal(w0, DIMS.split(runner.params[j])[0])  # independent draws
        assert float(b0.abs().max()) == float(b1.abs().max()) == float(bc.abs().max()) == 0.0
        for w in (w0, w1, wc):  # LeCun normal, truncated at two deviations
            fan_in = w.shape[0]
            assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.1
            assert float(w.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-6
    assert runner.env_states.batch_size == 8 and runner.obs.shape == (8, 4, L)


def test_stacked_converters_round_trip(jax_init):
    _, _, _, params = jax_init
    theta = convert.seac_params_from_flax(params)
    assert theta.shape == (N, DIMS.n_params)
    for i in range(N):
        row = convert.params_from_flax(jax.tree.map(lambda x: x[i], params))
        assert torch.equal(theta[i], row)
    back = convert.seac_params_to_flax(theta, DIMS)
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                              jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    policies = seac.seac_policies_of(DIMS, theta)
    assert len(policies) == N
    w = np.asarray(params["params"]["dense_0"]["kernel"])
    np.testing.assert_array_equal(policies[1].dense[0].weight.detach().numpy(), w[1].T)


def test_opt_state_converter_round_trip(jax_init):
    jenv, _, tx, params = jax_init
    opt = tx.init(params)
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32) * 1e-2, params)
    _, opt = tx.update(grads, opt, params)
    np_opt = jax.tree.map(np.asarray, opt)
    state = convert.seac_opt_state_from_optax(np_opt)
    assert state.count == 1 and state.mu.shape == (N, DIMS.n_params)
    np.testing.assert_array_equal(state.mu.numpy(),
                                  convert.seac_params_from_flax(np_opt[1][0].mu).numpy())
    back = convert.seac_opt_state_to_optax(state, DIMS, np_opt)
    assert int(back[1][0].count) == 1
    for name in ("mu", "nu"):
        for (p, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(getattr(back[1][0], name))[0],
                jax.tree_util.tree_flatten_with_path(getattr(np_opt[1][0], name))[0]):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {p}")


@pytest.mark.parametrize("seac_lambda", [1.0, 0.5])
def test_seac_ppo_loss_matches_jax(jax_init, seac_lambda):
    """The plain learner's flax-rounded loss, metrics and gradients against
    ``jax.value_and_grad`` of JAX's ``minibatch_loss``."""
    jenv, model, tx, params = jax_init
    jcfg = jax_seac.SEACPPOConfig(seac_lambda=seac_lambda)
    batch = make_flat_batch(5)
    loss = jax_minibatch_loss(jenv, model, tx, jcfg)
    (_, jm), jg = jit_bf16_exact(jax.value_and_grad(loss, has_aux=True), params,
                                 tuple(map(jnp.asarray, batch)))
    cfg = seac.SEACPPOConfig(seac_lambda=seac_lambda)
    theta = convert.seac_params_from_flax(params)
    grads, metrics = loss_grads(
        lambda p: seac.seac_ppo_loss(cfg, DIMS, p, tuple(map(torch.from_numpy, batch))), theta)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), err_msg=k, **METRIC_TOL)
    assert_stack_close(grads, jg, GRAD_TOL)


def test_optimizer_over_the_stack_matches_optax(jax_init):
    """``seac_optimizer_step`` against SEAC's ``optax.chain(
    clip_by_global_norm(0.5), adam(3e-4, eps=1e-5))`` over 5 steps, a
    constant lr.  At step 2 each agent's gradient has norm 0.4 and the
    stack's 0.57: one global norm across all agents clips it, a norm per
    agent would not."""
    _, _, tx, params = jax_init
    cfg = seac.SEACPPOConfig()
    opt = tx.init(params)
    theta = convert.seac_params_from_flax(params)
    state = convert.seac_opt_state_from_optax(jax.tree.map(np.asarray, opt))
    rng = np.random.default_rng(4)
    clipped = False
    for step in range(5):
        g = rng.standard_normal((N, DIMS.n_params)) * 1e-3
        if step == 2:
            g *= 0.4 / np.sqrt((g ** 2).sum(axis=1, keepdims=True))
        g = g.astype(np.float32)
        clipped |= float(np.sqrt((g.astype(np.float64) ** 2).sum())) >= cfg.max_grad_norm
        jg = jax.tree.map(jnp.asarray, convert.seac_params_to_flax(torch.from_numpy(g), DIMS))
        updates, opt = tx.update(jg, opt, params)
        params = optax.apply_updates(params, updates)
        theta, state = seac.seac_optimizer_step(cfg, theta, torch.from_numpy(g), state)
    assert clipped and state.count == 5
    tol = dict(rtol=1e-6, atol=1e-7)
    want = convert.seac_params_from_flax(jax.tree.map(np.asarray, params))
    np.testing.assert_allclose(theta.numpy(), want.numpy(), **tol)
    np_opt = jax.tree.map(np.asarray, opt)
    for name in ("mu", "nu"):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   convert.seac_params_from_flax(getattr(np_opt[1][0], name)).numpy(),
                                   err_msg=name, **tol)


def test_cross_values_match_jax(jax_init):
    """Agent i's critic on agent j's stored observations: the kernels'
    rounding against ``_native_forward``, the bootstrap against flax's
    ``model.apply``."""
    _, model, _, params = jax_init
    theta = convert.seac_params_from_flax(params)
    rng = np.random.default_rng(6)
    t_len, b = 3, 256
    obs = rng.standard_normal((t_len, b, N, L)).astype(np.float32)
    native = jnp.asarray(obs.reshape(t_len, 2, 128, N, L).transpose(0, 4, 3, 1, 2), jnp.bfloat16)
    want = jit_bf16_exact(lambda p, o: jax.vmap(lambda q: _native_forward(q, o)[1])(p), params,
                          native)  # (N_i, T, N_j, RB, LANE)
    got = seac.cross_values(DIMS, theta, torch.from_numpy(obs).to(torch.bfloat16))
    assert got.shape == (N, t_len, b, N)
    want = np.asarray(want).transpose(0, 1, 3, 4, 2).reshape(N, t_len, b, N)
    assert_values_close(got.numpy(), want)
    last = obs[0]
    jlast = jit_bf16_exact(lambda p, o: jax.vmap(lambda q: model.apply(q, o)[1])(p), params, last)
    glast = seac.cross_last_values(DIMS, theta, torch.from_numpy(last))
    assert glast.shape == (N, b, N)
    np.testing.assert_allclose(glast.numpy(), np.asarray(jlast), atol=1e-5)


def test_cross_gae_matches_jax():
    """GAE of agent j's rewards under agent i's critic: JAX's
    ``compute_gae`` once per agent i, the reward and done shared."""
    rng = np.random.default_rng(7)
    t_len, b = 6, 64
    reward = rng.standard_normal((t_len, b, N)).astype(np.float32)
    values = rng.standard_normal((N, t_len, b, N)).astype(np.float32)
    done = rng.random((t_len, b)) < 0.2
    last = rng.standard_normal((N, b, N)).astype(np.float32)
    cfg = seac.SEACPPOConfig()
    adv, tgt = seac.cross_gae(cfg, torch.from_numpy(reward), torch.from_numpy(values),
                              torch.from_numpy(done), torch.from_numpy(last))
    for i in range(N):
        jadv, jtgt = jax_ippo.compute_gae(JaxConfig(), reward, values[i], done, last[i])
        np.testing.assert_allclose(adv[i].numpy(), np.asarray(jadv), atol=1e-6)
        np.testing.assert_allclose(tgt[i].numpy(), np.asarray(jtgt), atol=1e-6)


def test_window_starts_follow_jax_rule():
    """Pass m of an epoch starts at ``(m * t_mb - off) % T`` with ``off`` any
    time row (``seac.py:562-568``); each epoch's windows tile the trajectory."""
    cfg = seac.SEACPPOConfig(rollout_len=32, epochs=3, minibatches=4)
    starts = seac.seac_window_starts(cfg, [0, 5, 31])
    assert starts.tolist() == [0, 8, 16, 24, 27, 3, 11, 19, 1, 9, 17, 25]
    for row in starts.reshape(3, 4).tolist():
        assert sorted((s + t) % 32 for s in row for t in range(8)) == list(range(32))
