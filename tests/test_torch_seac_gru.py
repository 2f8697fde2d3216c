"""The port's recurrent SEAC-PPO pieces against the JAX package: the per-agent
GRU init, the stacked GRU converters (parameters and optax state, message head
included), the cross replay of every agent's GRU over every agent's
observation stream (``seac._gru_cross_replay``) and the bootstrap from its last
carry, remat against no remat, and the minibatch loss and its gradient against
``minibatch_loss`` taken from ``build_seac_gru_train_step``'s closure.

Inputs are made with numpy from a seed; parameters go through
``rware_tpu_torch.convert`` from one stacked flax init with the biases moved
off zero.  The JAX side is compiled without XLA's excess precision
(``tests/torch_ref.jit_bf16_exact``), so both sides round to bf16 at the same
places and differ by float32 summation order.  Tolerances: the carries to the
bit on all but 0.5% of the entries and within one bf16 step (``|h| <= 1``),
heads and values within 2e-2 (the bounds of ``tests/test_torch_gru.py``);
loss metrics within rtol 2e-2, atol 2e-3 and gradients within 5% of each
leaf's largest |value|, as ``tests/test_torch_seac.py`` holds the MLP loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.models import seac as jax_seac
from rware_tpu.models.networks import RecurrentActorCritic as FlaxRecurrent
from rware_tpu_torch import convert
from rware_tpu_torch.models import seac
from rware_tpu_torch.models.networks import GruDims
from rware_tpu_torch.models.ppo import METRIC_KEYS, loss_grads
from tests.torch_ref import jit_bf16_exact

torch.set_num_threads(1)

N, L, E, HG, T, B = 2, 71, 32, 32, 8, 64
BF16_STEP = 2.0 ** -7
METRIC_TOL = dict(rtol=2e-2, atol=2e-3)
GRAD_TOL = 0.05


def stacked_gru_params(seed, msg_bits, n=N, obs_len=L):
    """N independent flax inits stacked on a leading agent axis
    (``init_seac_gru``), biases moved off zero."""
    model = FlaxRecurrent(n_actions=5, hidden=HG, embed=E, msg_bits=msg_bits)
    params = jax.vmap(lambda k: model.init(k, model.initialize_carry((1,)),
                                           jnp.zeros((1, obs_len))))(
        jax.random.split(jax.random.key(seed), n))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "bias" else np.asarray(x), params)
    return model, params


def replay_inputs(seed, msg_bits=0):
    """obs (T, B, N, L) in {0, 0.5, 1}, done (T, B) at 20%, a nonzero bf16
    carry (B, N, Hg), and random actions, bits and behaviour log-probs."""
    rng = np.random.default_rng(seed)
    obs = (rng.integers(0, 3, (T, B, N, L)) * 0.5).astype(np.float32)
    done = rng.random((T, B)) < 0.2
    h0 = np.array(jnp.asarray(rng.uniform(-1, 1, (B, N, HG)), jnp.bfloat16).astype(jnp.float32))
    action = rng.integers(0, 5, (T, B, N)).astype(np.int32)
    bits = rng.integers(0, 2, (T, B, N, msg_bits)).astype(np.int32)
    logp = (rng.standard_normal((T, B, N)) * 0.1 - 1.6 - 0.7 * msg_bits).astype(np.float32)
    cross = tuple(rng.standard_normal((T, B, N, N)).astype(np.float32) for _ in range(3))
    return obs, done, h0, action, bits, logp, cross


def port_replay(dims, theta, obs, done, h0, remat=False):
    return seac.gru_cross_replay(dims, theta, torch.from_numpy(obs), torch.from_numpy(done),
                                 torch.from_numpy(h0).to(torch.bfloat16), remat)


def assert_hidden_close(got, want):
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert diff.max() <= BF16_STEP + 1e-6, diff.max()
    assert (diff > 0).mean() <= 5e-3, (diff > 0).mean()


def test_init_draws_each_agent_its_own_gru():
    env = rware_tpu_torch.make("rware-small-4ag-v2", device="cpu", msg_bits=2)
    cfg = seac.SEACPPOConfig(n_envs=8, rollout_len=4)
    runner, dims = seac.init_seac_gru(env, cfg, seed=3, hidden=HG, embed=E)
    length = env.config.flattened_obs_length
    assert dims == GruDims(length, E, HG, 5, 2) and runner.params.shape == (4, dims.n_params)
    assert runner.carry.shape == (8, 4, HG) and runner.carry.dtype == torch.bfloat16
    assert float(runner.carry.float().abs().max()) == 0.0
    assert runner.opt_state.count == 0 and runner.opt_state.mu.shape == runner.params.shape
    again, _ = seac.init_seac_gru(env, cfg, seed=3, hidden=HG, embed=E)
    assert torch.equal(again.params, runner.params)
    for i in range(4):
        we, be, wi, bi, wh, bhn, wc, bc = dims.split(runner.params[i])
        for j in range(i):
            assert not torch.equal(wi, dims.split(runner.params[j])[2])  # independent draws
        assert float(be.abs().max()) == float(bi.abs().max()) == float(bc.abs().max()) == 0.0
        for q in range(3):  # orthogonal hidden gates
            w = wh[:, q * HG:(q + 1) * HG]
            torch.testing.assert_close(w.t() @ w, torch.eye(HG), atol=1e-5, rtol=0)
        assert abs(float(we.std()) * np.sqrt(length) - 1.0) < 0.15  # LeCun normal
    policies = seac.seac_gru_policies_of(dims, runner.params)
    assert len(policies) == 4 and policies[2].msg_bits == 2


@pytest.mark.parametrize("msg_bits", [0, 2])
def test_stacked_gru_converters_round_trip(msg_bits):
    model, params = stacked_gru_params(1, msg_bits)
    dims = GruDims(L, E, HG, 5, msg_bits)
    theta = convert.seac_params_from_flax(params)
    assert theta.shape == (N, dims.n_params)
    for i in range(N):
        assert torch.equal(theta[i], convert.gru_params_from_flax(
            jax.tree.map(lambda x: x[i], params)))
    jax.tree.map(np.testing.assert_array_equal, convert.seac_params_to_flax(theta, dims), params)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4, eps=1e-5))
    opt = tx.init(params)
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
    _, opt = tx.update(grads, opt, params)
    np_opt = jax.tree.map(np.asarray, opt)
    state = convert.seac_opt_state_from_optax(np_opt)
    assert state.count == 1 and state.nu.shape == (N, dims.n_params)
    back = convert.seac_opt_state_to_optax(state, dims, np_opt)
    jax.tree.map(np.testing.assert_array_equal, back[1][0].mu, np_opt[1][0].mu)
    jax.tree.map(np.testing.assert_array_equal, back[1][0].nu, np_opt[1][0].nu)
    if msg_bits:
        head = np.asarray(params["params"]["message"]["kernel"])
        np.testing.assert_array_equal(dims.split(theta[1])[6][:, 6:].numpy(), head[1])


@pytest.mark.parametrize("msg_bits", [0, 2])
def test_cross_replay_matches_jax(msg_bits):
    """Heads, values and the last carry of every (i, j) stream against
    ``_gru_cross_replay`` (the diagonal from the carry, the rest from
    zeros), and the bootstrap against agent i's ``model.apply`` on agent j's
    last observation from that carry."""
    model, params = stacked_gru_params(4, msg_bits)
    dims = GruDims(L, E, HG, 5, msg_bits)
    obs, done, h0, *_ = replay_inputs(5)
    jheads, jvalues, jcarry = jit_bf16_exact(
        lambda p, o, d, h: jax_seac._gru_cross_replay(model, p, o, d, h), params,
        jnp.asarray(obs), jnp.asarray(done), jnp.asarray(h0, jnp.bfloat16))
    theta = convert.seac_params_from_flax(params)
    heads, values, carry = port_replay(dims, theta, obs, done, h0)
    assert values.shape == (T, B, N, N) and carry.shape == (B, N, N, HG)
    assert carry.dtype == torch.bfloat16
    assert_hidden_close(carry.float(), np.asarray(jcarry.astype(jnp.float32)))
    pairs = zip(heads, jheads) if msg_bits else [(heads, jheads)]
    for got, want in list(pairs) + [(values, jvalues)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)
    # the diagonal starts from the carry: other carries change it, not the rest
    _, values2, _ = port_replay(dims, theta, obs, done, np.zeros_like(h0))
    assert not torch.equal(values2[0, :, 0, 0], values[0, :, 0, 0])
    assert torch.equal(values2[0, :, 0, 1], values[0, :, 0, 1])
    # the bootstrap: one flax step of agent i from carry (i, j) on obs j
    last_obs = obs[-1]
    want = jit_bf16_exact(
        lambda p, c, o: jax.vmap(lambda q, ci: model.apply(q, ci, o)[1][1], in_axes=(0, 1),
                                 out_axes=1)(p, c), params, jcarry, jnp.asarray(last_obs))
    got = seac.cross_bootstrap(dims, theta, carry, torch.from_numpy(last_obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)


def test_remat_equals_no_remat_bit_for_bit():
    """``remat`` computes the cell again in the backward: the loss and every
    gradient are the same to the bit (``test_seac_gru_remat_matches_no_remat``
    for JAX)."""
    _, params = stacked_gru_params(6, 2)
    dims = GruDims(L, E, HG, 5, 2)
    obs, done, h0, action, bits, logp, cross = replay_inputs(7, 2)
    batch = tuple(torch.from_numpy(x) for x in (obs, done, action, logp, *cross)) \
        + (torch.from_numpy(h0).to(torch.bfloat16), torch.from_numpy(bits))
    cfg = seac.SEACPPOConfig()
    theta = convert.seac_params_from_flax(params)
    out = [loss_grads(lambda p: seac.seac_gru_loss(cfg, dims, p, batch, remat), theta)
           for remat in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for k in METRIC_KEYS:
        assert torch.equal(out[0][1][k], out[1][1][k]), k
    assert float(out[0][0].abs().max()) > 0


def test_remat_rule_takes_the_gru_width():
    """Remat from about 2^31 residual elements (``seac.py:899-909``), counted
    with the model's GRU width: tiny-2ag at B=4,096 and width 128 runs
    without, medium-6ag with; width 16 moves the line."""
    def rule(n_envs, n, hidden):
        return seac.seac_gru_remat(seac.SEACPPOConfig(n_envs=n_envs), GruDims(L, 128, hidden), n)

    assert not rule(4096, 2, 128) and rule(4096, 6, 128) and not rule(4096, 6, 16)


def jax_gru_minibatch_loss(model, msg_bits):
    """``minibatch_loss`` of ``build_seac_gru_train_step``
    (``seac.py:986-1021``), taken from the train step's closure."""
    env = rware_tpu.make("rware-tiny-2ag-v2", msg_bits=msg_bits)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4, eps=1e-5))
    step = jax_seac.build_seac_gru_train_step(env, model, tx, jax_seac.SEACPPOConfig(n_envs=64))
    return step.__closure__[step.__code__.co_freevars.index("minibatch_loss")].cell_contents


@pytest.mark.parametrize("msg_bits", [0, 2])
def test_seac_gru_loss_matches_jax(msg_bits):
    """The loss, its metrics and every agent's gradient against
    ``jax.value_and_grad`` of JAX's recurrent ``minibatch_loss`` on one env
    band, message head included."""
    model, params = stacked_gru_params(8, msg_bits)
    dims = GruDims(L, E, HG, 5, msg_bits)
    obs, done, h0, action, bits, logp, cross = replay_inputs(9, msg_bits)
    jaction = np.concatenate([action[..., None], bits], -1) if msg_bits else action
    loss = jax_gru_minibatch_loss(model, msg_bits)
    jbatch = (jnp.asarray(obs), jnp.asarray(done), jnp.asarray(jaction), jnp.asarray(logp),
              *map(jnp.asarray, cross), jnp.asarray(h0, jnp.bfloat16))
    (_, jm), jg = jit_bf16_exact(jax.value_and_grad(loss, has_aux=True), params, jbatch)
    batch = tuple(torch.from_numpy(x) for x in (obs, done, action, logp, *cross)) \
        + (torch.from_numpy(h0).to(torch.bfloat16), torch.from_numpy(bits))
    theta = convert.seac_params_from_flax(params)
    cfg = seac.SEACPPOConfig()
    grads, metrics = loss_grads(lambda p: seac.seac_gru_loss(cfg, dims, p, batch), theta)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), err_msg=k, **METRIC_TOL)
    got = jax.tree_util.tree_flatten_with_path(convert.seac_params_to_flax(grads, dims))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jg))[0])
    assert len(got) == len(want) == 16 + 2 * bool(msg_bits)
    for path, g in got:
        w = want[path]
        np.testing.assert_allclose(g, w, atol=GRAD_TOL * max(np.abs(w).max(), 1e-6),
                                   err_msg=str(path))
