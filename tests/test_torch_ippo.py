"""The port's IPPO learner pieces against the JAX package: GAE, the PPO
losses and their gradients, the optimizer, and the plain learner.

Inputs are made with numpy from a seed; parameters and optimizer state go
through ``rware_tpu_torch.convert`` from one flax ``init`` / optax ``init``.
The JAX side is compiled without XLA's excess precision
(``tests/torch_ref.jit_bf16_exact``), so both round to bf16 at the same
places and differ by float32 summation order.
JAX trajectories in the native ``(T, L, N, RB, 128)`` layout hold env ``e`` at
``(e // 128, e % 128)`` (``pallas_rollout.py:1823-1828``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rware_tpu_torch
from rware_tpu.models import ActorCritic as FlaxActorCritic
from rware_tpu.models import IPPOConfig as JaxConfig
from rware_tpu.models import ippo as jax_ippo
from rware_tpu.models import ippo_pallas as jax_native
from rware_tpu.ops.pallas_rollout import LANE
from rware_tpu_torch.convert import (
    adam_state_from_optax,
    adam_state_to_optax,
    params_from_flax,
    params_to_flax,
)
from rware_tpu_torch.models import ippo
from rware_tpu_torch.models.ippo_fused import ppo_loss_native
from rware_tpu_torch.models.networks import (
    BlockDims,
    apply_forward,
    arrays_to_params,
    pack_arrays,
    params_to_arrays,
)
from tests.torch_ref import jit_bf16_exact

torch.set_num_threads(1)

T, N, L, RB = 4, 2, 71, 8
B = RB * LANE
DIMS = BlockDims(L, 128, 128, 5)
METRIC_TOL = dict(rtol=2e-2, atol=2e-3)  # test_pallas_update.py:51-56
GRAD_TOL = 0.05  # of max |ref| per leaf, test_pallas_update.py:57-66


def to_native(x):
    """(T, B, N[, L]) numpy -> the JAX native layout."""
    if x.ndim == 4:
        return jnp.asarray(x.reshape(T, RB, LANE, N, L).transpose(0, 4, 3, 1, 2))
    return jnp.asarray(x.reshape(T, RB, LANE, N).transpose(0, 3, 1, 2))


def make_batch(seed, t=T, b=B):
    """(obs, action, old_logp, old_value, adv, target) as numpy, (T, B, N, ...)."""
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((t, b, N, L)).astype(np.float32),
        rng.integers(0, 5, (t, b, N)).astype(np.int32),
        (rng.standard_normal((t, b, N)) * 0.1 - 1.6).astype(np.float32),
        *(rng.standard_normal((t, b, N)).astype(np.float32) for _ in range(3)),
    )


def torch_batch(batch):
    obs, *rest = batch
    return (torch.from_numpy(obs).to(torch.bfloat16), *map(torch.from_numpy, rest))


def flax_params(seed=0):
    return FlaxActorCritic(n_actions=5).init(jax.random.key(seed), jnp.zeros((1, N, L)))


def assert_leaves_close(got_flat, want_tree, frac):
    """Each flax leaf of ``got_flat`` within ``frac * max |want leaf|``."""
    got = jax.tree_util.tree_flatten_with_path(params_to_flax(got_flat, DIMS))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want_tree))[0])
    assert len(got) == len(want)
    for path, g in got:
        w = np.asarray(want[path])
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, atol=frac * max(np.abs(w).max(), 1e-6),
                                   err_msg=str(path))


@pytest.fixture(scope="module")
def case():
    params = flax_params(0)
    return params, params_from_flax(jax.tree.map(np.asarray, params)), make_batch(1)


def test_gae_matches_jax():
    rng = np.random.default_rng(2)
    reward = rng.standard_normal((T, B, N)).astype(np.float32)
    value = rng.standard_normal((T, B, N)).astype(np.float32)
    done = rng.random((T, B)) < 0.2
    last = rng.standard_normal((B, N)).astype(np.float32)
    cfg = ippo.IPPOConfig()
    adv, tgt = ippo.compute_gae(cfg, torch.from_numpy(reward), torch.from_numpy(value),
                                torch.from_numpy(done), torch.from_numpy(last))
    jadv, jtgt = jax_ippo.compute_gae(JaxConfig(), reward, value, done, last)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), atol=1e-6)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(jtgt), atol=1e-6)
    # compute_gae_native: the same recursion on the native layout
    nadv, _ = jax_native.compute_gae_native(
        JaxConfig(), to_native(reward), to_native(value),
        jnp.asarray(done.reshape(T, 1, RB, LANE).astype(np.int32)),
        jnp.asarray(last.reshape(RB, LANE, N).transpose(2, 0, 1)))
    np.testing.assert_allclose(to_native(adv.numpy()), np.asarray(nadv), atol=1e-6)


def test_bootstrap_value_follows_flax_apply():
    """``last_values`` (the bootstrap value of GAE) against flax's
    ``model.apply``, with the biases moved off zero as training moves them:
    flax rounds the product and then the bf16 sum with the bias."""
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        flax_params(4))
    obs = rng.standard_normal((B, N, L)).astype(np.float32)
    jlogits, jvalue = jit_bf16_exact(FlaxActorCritic(n_actions=5).apply, params, obs)
    theta = params_from_flax(params)
    logits, value = apply_forward(DIMS.split(theta), torch.from_numpy(obs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), atol=1e-5)
    np.testing.assert_array_equal(ippo.last_values(DIMS, theta, torch.from_numpy(obs)).numpy(),
                                  value.numpy())


def test_ppo_loss_native_matches_jax(case):
    params, theta, batch = case
    jbatch = (to_native(batch[0]).astype(jnp.bfloat16),) + tuple(map(to_native, batch[1:]))
    (_, jm), jg = jit_bf16_exact(lambda p, b: jax.value_and_grad(
        jax_native.ppo_loss_native, argnums=1, has_aux=True)(JaxConfig(), p, b), params, jbatch)
    grads, metrics = ippo.loss_grads(
        lambda p: ppo_loss_native(ippo.IPPOConfig(), DIMS, p, torch_batch(batch)), theta)
    for k in ippo.METRIC_KEYS:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), err_msg=k, **METRIC_TOL)
    assert_leaves_close(grads, jg, GRAD_TOL)


def test_ppo_loss_flat_matches_jax(case):
    """``ppo_loss`` on a flat (M, N, ...) minibatch against JAX's (flax
    ``apply``: bf16 dense layers)."""
    params, theta, batch = case
    flat = tuple(x.reshape((T * B,) + x.shape[2:]) for x in batch)
    jbatch = (jnp.asarray(flat[0]),) + tuple(map(jnp.asarray, flat[1:]))
    model = FlaxActorCritic(n_actions=5)
    (_, jm), jg = jit_bf16_exact(lambda p, b: jax.value_and_grad(
        lambda q: jax_ippo.ppo_loss(model, JaxConfig(), q, b), has_aux=True)(p), params, jbatch)
    tb = (torch.from_numpy(flat[0]),) + tuple(map(torch.from_numpy, flat[1:]))
    grads, metrics = ippo.loss_grads(lambda p: ippo.ppo_loss(ippo.IPPOConfig(), DIMS, p, tb),
                                     theta)
    for k in ippo.METRIC_KEYS:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), err_msg=k, **METRIC_TOL)
    assert_leaves_close(grads, jg, GRAD_TOL)


@pytest.mark.parametrize("anneal", [False, True])
def test_optimizer_matches_optax(anneal):
    """``optimizer_step`` against ``optax.chain(clip_by_global_norm,
    adam(eps=1e-5))`` over 5 steps; step 2's gradient is scaled so that the
    global-norm clip triggers."""
    cfg = ippo.IPPOConfig(anneal_lr=anneal, total_updates=2, epochs=1, minibatches=2)
    jcfg = JaxConfig(anneal_lr=anneal, total_updates=2, epochs=1, minibatches=2)
    params = flax_params(3)
    tx = jax_ippo.make_optimizer(jcfg)
    opt = tx.init(params)
    theta = params_from_flax(jax.tree.map(np.asarray, params))
    state = adam_state_from_optax(jax.tree.map(np.asarray, opt))
    rng = np.random.default_rng(4)
    clipped = False
    for step in range(5):
        g = (rng.standard_normal(DIMS.n_params) * 0.01 * (100.0 if step == 2 else 1.0))
        g = g.astype(np.float32)
        clipped |= float(np.sqrt((g.astype(np.float64) ** 2).sum())) >= cfg.max_grad_norm
        jg = jax.tree.map(jnp.asarray, params_to_flax(torch.from_numpy(g), DIMS))
        updates, opt = tx.update(jg, opt, params)
        params = optax.apply_updates(params, updates)
        theta, state = ippo.optimizer_step(cfg, theta, torch.from_numpy(g), state)
    assert clipped
    tol = dict(rtol=1e-6, atol=1e-7)
    want = params_from_flax(jax.tree.map(np.asarray, params))
    np.testing.assert_allclose(theta.numpy(), want.numpy(), **tol)
    back = adam_state_to_optax(state, DIMS, jax.tree.map(np.asarray, opt))
    assert int(back[1][0].count) == int(opt[1][0].count) == 5
    if anneal:
        assert int(back[1][1].count) == int(opt[1][1].count) == 5
    for name in ("mu", "nu"):
        want = params_from_flax(jax.tree.map(np.asarray, getattr(opt[1][0], name)))
        np.testing.assert_allclose(getattr(state, name).numpy(), want.numpy(), **tol,
                                   err_msg=name)


def test_lr_schedule_matches_optax():
    cfg = ippo.IPPOConfig(anneal_lr=True, total_updates=3)
    sched = jax_ippo.make_lr_schedule(JaxConfig(anneal_lr=True, total_updates=3))
    for count in (0, 1, 17, 47, 48, 60):
        assert float(ippo.make_lr_schedule(cfg)(count)) == float(sched(count)), count
    assert float(ippo.make_lr_schedule(ippo.IPPOConfig())(5)) == np.float32(3e-4)


def test_params_and_opt_state_round_trip(case):
    params, theta, _ = case
    back = params_to_flax(theta, DIMS)
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                              jax.tree_util.tree_flatten_with_path(
                                  jax.tree.map(np.asarray, params))[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    model = arrays_to_params(DIMS.split(theta))
    assert torch.equal(pack_arrays(params_to_arrays(model)), theta)


def test_collect_seed_keys_are_disjoint():
    keys = {ippo.collect_seed(s, u) for s in range(3) for u in range(1000)}
    assert len(keys) == 3000
    assert ippo.collect_seed(1, 0) == 2**32
    with pytest.raises(ValueError):
        ippo.collect_seed(2**32, 0)


@pytest.mark.parametrize("mode", ["shuffle", "block"])
def test_plain_learner_trains(mode):
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu")
    cfg = ippo.IPPOConfig(n_envs=32, rollout_len=8, epochs=2, minibatches=2,
                          minibatch_mode=mode)
    runner, dims = ippo.init_runner(env, cfg, seed=0)
    step = ippo.build_train_step(env, dims, cfg)
    new, metrics = step(runner)
    assert new.update_idx == 1 and new.opt_state.count == 4
    assert set(metrics) == {"reward_per_env", "episodes_done", *ippo.METRIC_KEYS}
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    assert float((new.params - runner.params).abs().max()) > 0
    assert float(metrics["entropy"]) > 1.5  # near-uniform policy at init
