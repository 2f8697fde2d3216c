"""The port's MAPPO learner pieces against the JAX package: the central
critic in both roundings, the MAPPO loss and the critic-only value loss with
their gradients, the split optimizer, the converters and the runner.

Inputs are made with numpy from a seed; parameters and optimizer state go
through ``rware_tpu_torch.convert`` from one flax ``init`` / optax ``init``.
The JAX side is compiled without XLA's excess precision
(``tests/torch_ref.jit_bf16_exact``), so both round to bf16 at the same
places and differ by float32 summation order: a hidden unit's bf16 rounding
flips now and then, which moves a value by a few 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rware_tpu_torch
from rware_tpu.models import IPPOConfig as JaxConfig
from rware_tpu.models import mappo as jax_mappo
from rware_tpu.models.networks import CentralCritic as FlaxCentralCritic
from rware_tpu_torch.convert import (
    central_critic_from_flax,
    critic_params_from_flax,
    critic_params_to_flax,
    mappo_opt_state_from_optax,
    mappo_opt_state_to_optax,
    params_from_flax,
    params_to_flax,
)
from rware_tpu_torch.models import ippo, mappo
from rware_tpu_torch.models.networks import (
    CriticDims,
    critic_apply_forward,
    critic_to_arrays,
    critic_train_forward,
    init_central_critic,
    joint_obs,
    pack_arrays,
)
from rware_tpu_torch.models.ppo import critic_value_loss, loss_grads, mappo_loss_native
from tests.test_torch_ippo import (
    DIMS,
    GRAD_TOL,
    METRIC_TOL,
    N,
    B,
    L,
    assert_leaves_close,
    flax_params,
    make_batch,
    to_native,
    torch_batch,
)
from tests.torch_ref import jit_bf16_exact

torch.set_num_threads(1)

CDIMS = CriticDims(N, L, 128, 128)


def flax_critic_params(seed=0, noise=0.0):
    """A flax CentralCritic init; ``noise`` moves every leaf off its init
    (biases off zero, as training moves them)."""
    params = FlaxCentralCritic(n_agents=N).init(jax.random.key(seed), jnp.zeros((1, N * L)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + noise * rng.standard_normal(x.shape).astype(np.float32), params)


def assert_critic_leaves_close(got_flat, want_tree, frac):
    """Each flax leaf of the critic's ``got_flat`` within ``frac * max |want leaf|``."""
    got = jax.tree_util.tree_flatten_with_path(critic_params_to_flax(got_flat, CDIMS))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want_tree))[0])
    assert len(got) == len(want) == 6
    for path, g in got:
        w = np.asarray(want[path])
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, atol=frac * max(np.abs(w).max(), 1e-6),
                                   err_msg=str(path))


def assert_values_close(got, want):
    """Values within 1e-5 on at least 98% of the rows, and nowhere further
    apart than a flipped bf16 rounding of a hidden unit (a step of up to
    2**-8) times a head weight of up to 0.5: 2e-3."""
    diff = np.abs(np.asarray(got) - np.asarray(want)).reshape(-1, N).max(axis=1)
    assert (diff < 1e-5).mean() > 0.98, (diff < 1e-5).mean()
    assert diff.max() < 2e-3, diff.max()


@pytest.fixture(scope="module")
def case():
    params = {"actor": flax_params(0), "critic": flax_critic_params(1, noise=0.02)}
    np_params = jax.tree.map(np.asarray, params)
    theta = {"actor": params_from_flax(np_params["actor"]),
             "critic": critic_params_from_flax(np_params["critic"])}
    return params, theta, make_batch(1)


def test_central_critic_follows_flax_apply():
    """``critic_apply_forward`` (MAPPO's bootstrap value) and the
    ``CentralCritic`` module against flax's ``CentralCritic.apply``."""
    params = flax_critic_params(4, noise=0.05)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, N * L)).astype(np.float32)
    want = jit_bf16_exact(FlaxCentralCritic(n_agents=N).apply, params, x)
    theta = critic_params_from_flax(params)
    got = critic_apply_forward(CDIMS.split(theta), torch.from_numpy(x))
    assert got.shape == (B, N) and got.dtype == torch.float32
    assert_values_close(got.numpy(), want)
    with torch.no_grad():
        module = central_critic_from_flax(params)(torch.from_numpy(x))
    np.testing.assert_allclose(module.numpy(), got.numpy(), atol=1e-6)
    obs = torch.from_numpy(x.reshape(B, N, L))
    np.testing.assert_array_equal(mappo.critic_last_values(CDIMS, theta, obs).numpy(),
                                  got.numpy())


def test_critic_train_forward_matches_native(case):
    """The kernels' rounding: ``_critic_native_forward(_joint_native(obs))``."""
    params, theta, batch = case
    jobs = to_native(batch[0]).astype(jnp.bfloat16)
    want = jit_bf16_exact(
        lambda cp, o: jax_mappo._critic_native_forward(cp, jax_mappo._joint_native(o)),
        params["critic"], jobs)
    obs = torch.from_numpy(batch[0]).to(torch.bfloat16)
    got = critic_train_forward(CDIMS.split(theta["critic"]), joint_obs(obs))
    assert got.shape == batch[1].shape
    assert_values_close(np.asarray(to_native(got.numpy())), want)


def test_two_critic_roundings_differ_once_biases_move(case):
    """The bootstrap value must not take the training forward: with nonzero
    biases the two roundings give different values."""
    _, theta, batch = case
    x = joint_obs(torch.from_numpy(batch[0][0]))
    blocks = CDIMS.split(theta["critic"])
    diff = (critic_apply_forward(blocks, x) - critic_train_forward(blocks, x)).abs()
    assert float(diff.max()) > 1e-4


def test_mappo_loss_native_matches_jax(case):
    params, theta, batch = case
    jbatch = (to_native(batch[0]).astype(jnp.bfloat16),) + tuple(map(to_native, batch[1:]))
    (_, jm), jg = jit_bf16_exact(lambda p, b: jax.value_and_grad(
        jax_mappo.mappo_loss_native, argnums=1, has_aux=True)(JaxConfig(), p, b), params, jbatch)
    grads, metrics = loss_grads(
        lambda p: mappo_loss_native(ippo.IPPOConfig(), DIMS, CDIMS, p, torch_batch(batch)), theta)
    for k in ippo.METRIC_KEYS:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), err_msg=k, **METRIC_TOL)
    assert_leaves_close(grads["actor"], jg["actor"], GRAD_TOL)
    assert_critic_leaves_close(grads["critic"], jg["critic"], GRAD_TOL)


def test_actor_value_head_gradient_is_exactly_zero(case):
    """MAPPO's value term is the critic's: the actor's local value head
    (column A of the head block, and its bias) gets exactly 0.0."""
    _, theta, batch = case
    grads, _ = loss_grads(
        lambda p: mappo_loss_native(ippo.IPPOConfig(), DIMS, CDIMS, p, torch_batch(batch)), theta)
    blocks = DIMS.split(grads["actor"])
    assert float(blocks[4][:, DIMS.n_actions].abs().max()) == 0.0
    assert float(blocks[5][0, DIMS.n_actions].abs()) == 0.0
    assert float(blocks[4][:, :DIMS.n_actions].abs().max()) > 0  # the policy head learns
    assert float(grads["critic"].abs().max()) > 0


def test_critic_value_loss_matches_jax(case):
    """The critic-only clipped value loss (``mappo.py:870-879``)."""
    params, theta, batch = case
    cfg = JaxConfig()
    jobs = to_native(batch[0]).astype(jnp.bfloat16)
    old_value, target = to_native(batch[3]), to_native(batch[5])

    def loss(cp):
        value = jax_mappo._critic_native_forward(cp, jax_mappo._joint_native(jobs))
        v_clipped = old_value + jnp.clip(value - old_value, -cfg.clip_eps, cfg.clip_eps)
        v_loss = 0.5 * jnp.maximum((value - target) ** 2, (v_clipped - target) ** 2).mean()
        return cfg.vf_coef * v_loss, v_loss

    (_, jv), jg = jit_bf16_exact(jax.value_and_grad(loss, has_aux=True), params["critic"])
    tb = torch_batch(batch)
    grads, metrics = loss_grads(
        lambda p: critic_value_loss(ippo.IPPOConfig(), CDIMS, p, (tb[0], tb[3], tb[5])),
        theta["critic"])
    np.testing.assert_allclose(float(metrics["v_loss"]), float(jv), **METRIC_TOL)
    assert_critic_leaves_close(grads, jg, GRAD_TOL)


def test_split_optimizer_matches_optax():
    """``mappo_optimizer_step`` against ``make_mappo_optimizer`` over 4
    steps: each part is clipped by its own global norm (step 1's critic
    gradient alone is large enough to be clipped)."""
    cfg, jcfg = ippo.IPPOConfig(), JaxConfig()
    params = {"actor": flax_params(3), "critic": flax_critic_params(5)}
    tx = jax_mappo.make_mappo_optimizer(jcfg)
    opt = tx.init(params)
    np_params = jax.tree.map(np.asarray, params)
    theta = {"actor": params_from_flax(np_params["actor"]),
             "critic": critic_params_from_flax(np_params["critic"])}
    state = mappo_opt_state_from_optax(jax.tree.map(np.asarray, opt))
    rng = np.random.default_rng(4)
    for step in range(4):
        g = {"actor": rng.standard_normal(DIMS.n_params).astype(np.float32) * 1e-3,
             "critic": rng.standard_normal(CDIMS.n_params).astype(np.float32)
             * (1.0 if step == 1 else 1e-3)}
        jg = {"actor": jax.tree.map(jnp.asarray, params_to_flax(torch.from_numpy(g["actor"]),
                                                                DIMS)),
              "critic": jax.tree.map(jnp.asarray, critic_params_to_flax(
                  torch.from_numpy(g["critic"]), CDIMS))}
        updates, opt = tx.update(jg, opt, params)
        params = optax.apply_updates(params, updates)
        theta, state = mappo.mappo_optimizer_step(
            cfg, theta, {k: torch.from_numpy(v) for k, v in g.items()}, state)
    tol = dict(rtol=1e-6, atol=1e-7)
    np_params = jax.tree.map(np.asarray, params)
    np.testing.assert_allclose(theta["actor"].numpy(),
                               params_from_flax(np_params["actor"]).numpy(), **tol)
    np.testing.assert_allclose(theta["critic"].numpy(),
                               critic_params_from_flax(np_params["critic"]).numpy(), **tol)
    np_opt = jax.tree.map(np.asarray, opt)
    back = mappo_opt_state_to_optax(state, DIMS, CDIMS, np_opt)
    for part in ("actor", "critic"):
        assert state[part].count == int(opt[part][1][0].count) == 4
        assert int(back[part][1][0].count) == 4
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(back[part][1][0].nu)[0],
                jax.tree_util.tree_flatten_with_path(np_opt[part][1][0].nu)[0]):
            np.testing.assert_allclose(a, b, err_msg=f"{part} {path}", **tol)


def test_critic_converters_round_trip():
    params = flax_critic_params(2, noise=0.1)
    theta = critic_params_from_flax(params)
    assert theta.shape == (CDIMS.n_params,) == (N * L * 128 + 128 + 128 * 128 + 128 + 128 * N + N,)
    back = critic_params_to_flax(theta, CDIMS)
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                              jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    model = central_critic_from_flax(params)
    assert CriticDims.of(model) == CDIMS
    assert torch.equal(pack_arrays(critic_to_arrays(model)).detach(), theta)
    # dense_0 keeps flax's agent-major rows: row n * L + l is agent n's feature l
    w0 = CDIMS.split(theta)[0]
    np.testing.assert_array_equal(w0[1 * L + 3].numpy(),
                                  np.asarray(params["params"]["dense_0"]["kernel"])[L + 3])


def test_init_central_critic_follows_flax_default_init():
    a = init_central_critic(N * L, N, (128, 128), seed=(7, 1))
    b = init_central_critic(N * L, N, (128, 128), seed=(7, 1))
    c = init_central_critic(N * L, N, (128, 128), seed=(8, 1))
    assert torch.equal(a.dense[0].weight, b.dense[0].weight)
    assert not torch.equal(a.dense[0].weight, c.dense[0].weight)
    for layer in list(a.dense) + [a.value]:
        fan_in = layer.weight.shape[1]
        assert float(layer.bias.abs().max()) == 0.0
        std = float(layer.weight.std())
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.1, (fan_in, std)  # LeCun normal
        assert float(layer.weight.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-6


def test_init_mappo_runner():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu")
    cfg = ippo.IPPOConfig(n_envs=8, rollout_len=4)
    runner, dims, cdims = mappo.init_mappo_runner(env, cfg, seed=3)
    assert dims == DIMS and cdims == CDIMS
    assert set(runner.params) == set(runner.opt_state) == {"actor", "critic"}
    assert runner.params["actor"].shape == (DIMS.n_params,)
    assert runner.params["critic"].shape == (CDIMS.n_params,)
    for part in ("actor", "critic"):
        assert runner.opt_state[part].count == 0
        assert float(runner.opt_state[part].mu.abs().max()) == 0.0
    # the actor is IPPO's actor of the same seed
    irunner, _ = ippo.init_runner(env, cfg, seed=3)
    assert torch.equal(runner.params["actor"], irunner.params)
    again, _, _ = mappo.init_mappo_runner(env, cfg, seed=3)
    assert torch.equal(again.params["critic"], runner.params["critic"])


def test_make_defaults_to_the_card():
    """``make`` and ``Warehouse`` run on the card unless asked for the CPU;
    where there is none they raise and pick nothing silently."""
    if torch.cuda.is_available():
        assert rware_tpu_torch.make("rware-tiny-2ag-v2").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rware_tpu_torch.make("rware-tiny-2ag-v2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rware_tpu_torch.Warehouse(rware_tpu_torch.parse_env_id("rware-tiny-2ag-v2"))
    assert rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu").device.type == "cpu"
