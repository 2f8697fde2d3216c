"""K4's message head on the CPU: the plain version of ``FusedPPOGrads`` with
``msg_bits=2`` against ``build_fused_ppo_grads(interpret=True, msg_bits=2)``
as ``tests/test_pallas_update.py:130`` runs it (the whole trajectory as one
window, and windows read in place that wrap); the joint move + Bernoulli
loss against ``ippo_pallas.ppo_loss_native``; the flax -> port converters of
a ``message`` head; and the kernels that take no message head refusing it.

The JAX side is compiled without XLA's excess precision
(``tests/torch_ref.jit_bf16_exact``); both sides round to bf16 at the same
places and differ by float32 summation order, so the JAX tests' own bounds
hold: gradients within 5% of each leaf's largest |value|, metrics within
rtol 2e-2, atol 2e-3 (``tests/test_pallas_update.py:51-66``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rware_tpu.models import ActorCritic as FlaxActorCritic
from rware_tpu.models import IPPOConfig as JaxConfig
from rware_tpu.models import ippo_pallas as jax_native
from rware_tpu.models.networks import RecurrentActorCritic as FlaxRecurrent
from rware_tpu.ops.pallas_rollout import LANE
from rware_tpu.ops.pallas_update import build_fused_ppo_grads as jax_grads
from rware_tpu_torch import convert
from rware_tpu_torch.models import ippo
from rware_tpu_torch.models.networks import BlockDims, CriticDims, GruDims, gru_to_arrays
from rware_tpu_torch.models.ppo import ppo_loss_native
from rware_tpu_torch.ops.fused_mappo import build_fused_mappo_grads, build_fused_mappo_update_phase
from rware_tpu_torch.ops.fused_seac import FusedSeacGrads
from rware_tpu_torch.ops.fused_update import (
    build_fused_ppo_grads,
    build_fused_ppo_update_phase,
    metric_means,
)
from tests.torch_ref import jit_bf16_exact

torch.set_num_threads(1)

T, N, RB, M = 4, 2, 8, 2
B, L = RB * LANE, 89  # tiny-2ag's observation with two message bits
DIMS = BlockDims(L, 128, 128, 5, M)
KW = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01)
JAX_KW = dict(obs_len=L, hidden=(128, 128), n_actions=5, n_agents=N, mb_rows=RB, msg_bits=M, **KW)
METRIC_TOL = dict(rtol=2e-2, atol=2e-3)
GRAD_TOL = 0.05


def to_native(x):
    """(T, B, N[, L]) numpy -> the JAX native layout; bits (T, B, N, M) ->
    (T, N * M, RB, LANE), rows i * M + m (``pallas_rollout.py:1817-1818``)."""
    if x.ndim == 4 and x.shape[-1] == M:
        return jnp.asarray(x.reshape(T, RB, LANE, N * M).transpose(0, 3, 1, 2))
    if x.ndim == 4:
        return jnp.asarray(x.reshape(T, RB, LANE, N, L).transpose(0, 4, 3, 1, 2))
    return jnp.asarray(x.reshape(T, RB, LANE, N).transpose(0, 3, 1, 2))


@pytest.fixture(scope="module")
def case():
    params = FlaxActorCritic(n_actions=5, msg_bits=M).init(jax.random.key(0),
                                                           jnp.zeros((1, N, L)))
    rng = np.random.default_rng(1)
    batch = (
        (rng.random((T, B, N, L)) < 0.3).astype(np.float32),
        rng.integers(0, 5, (T, B, N)).astype(np.int32),
        (rng.standard_normal((T, B, N)) * 0.1 - 3.0).astype(np.float32),
        *(rng.standard_normal((T, B, N)).astype(np.float32) for _ in range(3)),
        rng.integers(0, 2, (T, B, N, M)).astype(np.int32),
    )
    jbatch = (to_native(batch[0]).astype(jnp.bfloat16),) + tuple(map(to_native, batch[1:]))
    tbatch = (torch.from_numpy(batch[0]).to(torch.bfloat16),) + tuple(map(torch.from_numpy,
                                                                          batch[1:]))
    theta = convert.params_from_flax(jax.tree.map(np.asarray, params))
    return params, theta, tbatch, jbatch


def assert_leaves_close(got_flat, want_tree):
    """Each flax leaf of ``got_flat`` within 5% of ``want``'s largest |value|."""
    got = jax.tree_util.tree_flatten_with_path(convert.params_to_flax(got_flat, DIMS))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want_tree))[0])
    assert len(got) == len(want) == 10  # message kernel and bias included
    for path, g in got:
        w = np.asarray(want[path])
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, atol=GRAD_TOL * max(np.abs(w).max(), 1e-6),
                                   err_msg=str(path))


def _check_metrics(sums, jax_metrics, n):
    got = metric_means(sums, n)
    for k in ippo.METRIC_KEYS:
        np.testing.assert_allclose(float(got[k]), float(jax_metrics[k]), err_msg=k,
                                   **METRIC_TOL)


def test_k4_plain_matches_jax_sliced(case):
    params, theta, batch, jbatch = case
    jg, jm = jit_bf16_exact(jax_grads(rollout_len=T, interpret=True, **JAX_KW), params, jbatch)
    k4 = build_fused_ppo_grads(DIMS, T, **KW)
    grads, sums = k4(theta, batch, 0)
    assert k4.launches == 0 and k4.hc == 8  # CPU: the plain version; A + 1 + M = 8 rows
    _check_metrics(sums, jm, T * B * N)
    assert_leaves_close(grads, jg)
    # the entropy is the joint one: above the move's largest, log 5
    assert np.log(5) + 1 < float(metric_means(sums, T * B * N)["entropy"]) <= np.log(20)


@pytest.mark.parametrize("start", [1, T - 1])
def test_k4_plain_matches_jax_zero_copy(case, start):
    """Two-row windows read in place; T - 1 wraps around the end."""
    params, theta, batch, jbatch = case
    zc = jax_grads(rollout_len=T // 2, dataset_len=T, interpret=True, **JAX_KW)
    jg, jm = jit_bf16_exact(zc, params, jbatch, jnp.int32(start))
    grads, sums = build_fused_ppo_grads(DIMS, T // 2, **KW)(theta, batch, start)
    _check_metrics(sums, jm, T // 2 * B * N)
    assert_leaves_close(grads, jg)


def test_joint_loss_matches_jax(case):
    """``ppo_loss_native`` with the bits against JAX's (autograd on both
    sides): the joint ratio, the joint entropy, the message head's gradient."""
    params, theta, batch, jbatch = case
    (_, jm), jg = jit_bf16_exact(lambda p, b: jax.value_and_grad(
        jax_native.ppo_loss_native, argnums=1, has_aux=True)(JaxConfig(), p, b), params, jbatch)
    grads, metrics = ippo.loss_grads(
        lambda p: ppo_loss_native(ippo.IPPOConfig(), DIMS, p, batch), theta)
    for k in ippo.METRIC_KEYS:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), err_msg=k, **METRIC_TOL)
    assert_leaves_close(grads, jg)


def test_converters_carry_the_message_head():
    """flax -> port -> flax is the identity with a ``message`` head, for the
    MLP (module and flat vector) and the GRU; the port's forward returns
    ``(logits, msg_logits)`` as flax's does, within the bf16 rounding."""
    params = jax.tree.map(np.asarray, FlaxActorCritic(n_actions=5, msg_bits=3).init(
        jax.random.key(2), jnp.zeros((1, 2, 95))))
    model = convert.actor_critic_from_flax(params)
    assert model.msg_bits == 3 and model.message.weight.shape == (3, 128)
    back = convert.actor_critic_to_flax(model)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    dims = BlockDims.of(model)
    flat = convert.params_from_flax(params)
    assert flat.shape == (dims.n_params,) and dims.heads == 9
    jax.tree.map(np.testing.assert_array_equal, convert.params_to_flax(flat, dims), params)
    obs = np.random.default_rng(0).integers(0, 2, (6, 2, 95)).astype(np.float32)
    (jl, jm), jv = FlaxActorCritic(n_actions=5, msg_bits=3).apply(params, jnp.asarray(obs))
    (logits, msg), value = model(torch.from_numpy(obs))
    for got, want in ((logits, jl), (msg, jm), (value, jv)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-2)
    gparams = jax.tree.map(np.asarray, FlaxRecurrent(n_actions=5, hidden=16, embed=16,
                                                     msg_bits=2).init(
        jax.random.key(3), jnp.zeros((1, 16), jnp.bfloat16), jnp.zeros((1, 95))))
    gru = convert.recurrent_from_flax(gparams)
    gdims = GruDims.of(gru)
    assert gru.msg_bits == 2 and gdims.shapes[6] == (16, 8)
    gflat = convert.gru_params_from_flax(gparams)
    jax.tree.map(np.testing.assert_array_equal, convert.gru_params_to_flax(gflat, gdims), gparams)
    assert torch.equal(torch.cat([a.reshape(-1) for a in gru_to_arrays(gru)]), gflat)


def test_kernels_without_a_message_head_refuse_it():
    """K3, K5, K7 and K8 have no message head (``ippo_pallas.py:545-556``,
    ``mappo.py:369-393``); they raise rather than drop the bits."""
    cdims = CriticDims(N, L, 128, 128)
    with pytest.raises(NotImplementedError, match="no message head"):
        build_fused_ppo_update_phase(DIMS, 8, 2, 2, max_grad_norm=0.5, **KW)
    with pytest.raises(NotImplementedError, match="no message head"):
        build_fused_mappo_grads(DIMS, cdims, 4, **KW)
    with pytest.raises(NotImplementedError, match="no message head"):
        build_fused_mappo_update_phase(DIMS, cdims, 8, 2, 2, max_grad_norm=0.5, **KW)
    with pytest.raises(NotImplementedError, match="no message head"):
        FusedSeacGrads(DIMS, N, 4, seac_lambda=1.0, **KW)
    with pytest.raises(ValueError, match="7 tensors"):
        k4 = build_fused_ppo_grads(DIMS, 2, **KW)
        k4.check(torch.zeros(DIMS.n_params), (torch.zeros((2, 4, N, L), dtype=torch.bfloat16),))
