"""The plain versions of the fused PPO kernels K4 (``FusedPPOGrads``) and K3
(``FusedPPOUpdatePhase``) against the JAX Pallas kernels in interpret mode,
as ``tests/test_pallas_update.py`` runs them, and against the port's own
per-pass path.  The CUDA kernels run only on a GPU
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

The JAX side is compiled without XLA's excess precision
(``tests/torch_ref.jit_bf16_exact``): both sides then round to bf16 at the
same places and differ by float32 summation order, well inside the JAX
tests' own bounds, which are kept here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu_torch
from rware_tpu.models import ippo_pallas as jax_native
from rware_tpu.ops.pallas_update import build_fused_ppo_grads as jax_grads
from rware_tpu.ops.pallas_update import build_fused_ppo_update_phase as jax_phase
from rware_tpu_torch.convert import params_from_flax
from rware_tpu_torch.models import ippo
from rware_tpu_torch.models.ippo_fused import (
    phase_advstats,
    phase_window_starts,
    ppo_update_epochs_native,
    ppo_update_phase_fused,
)
from rware_tpu_torch.models.networks import pack_arrays
from rware_tpu_torch.ops.fused_update import (
    build_fused_ppo_grads,
    build_fused_ppo_update_phase,
    metric_means,
    phase_time_block,
)
from tests.test_torch_ippo import (
    DIMS,
    GRAD_TOL,
    METRIC_TOL,
    N,
    RB,
    B,
    L,
    T,
    assert_leaves_close,
    flax_params,
    make_batch,
    to_native,
    torch_batch,
)
from tests.torch_ref import jit_bf16_exact

torch.set_num_threads(1)

KW = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01)
JAX_KW = dict(obs_len=L, hidden=(128, 128), n_actions=5, n_agents=N, mb_rows=RB, **KW)


@pytest.fixture(scope="module")
def case():
    params = flax_params(0)
    batch = make_batch(1)
    jbatch = (to_native(batch[0]).astype(jnp.bfloat16),) + tuple(map(to_native, batch[1:]))
    theta = params_from_flax(jax.tree.map(np.asarray, params))
    return params, theta, torch_batch(batch), jbatch


def _check_metrics(sums, jax_metrics, n):
    got = metric_means(sums, n)
    for k in ippo.METRIC_KEYS:
        np.testing.assert_allclose(float(got[k]), float(jax_metrics[k]), err_msg=k,
                                   **METRIC_TOL)


def test_k4_plain_matches_jax_sliced(case):
    """The whole trajectory as one window: JAX's non-zero-copy kernel."""
    params, theta, batch, jbatch = case
    jg, jm = jit_bf16_exact(jax_grads(rollout_len=T, interpret=True, **JAX_KW), params, jbatch)
    k4 = build_fused_ppo_grads(DIMS, T, **KW)
    grads, sums = k4(theta, batch, 0)
    assert k4.launches == 0  # CPU tensors take the plain version
    _check_metrics(sums, jm, T * B * N)
    assert_leaves_close(grads, jg, GRAD_TOL)


@pytest.mark.parametrize("start", [0, 1, T - 1])
def test_k4_plain_matches_jax_zero_copy(case, start):
    """Two-row windows read in place; T - 1 wraps around the end."""
    params, theta, batch, jbatch = case
    zc = jax_grads(rollout_len=T // 2, dataset_len=T, interpret=True, **JAX_KW)
    jg, jm = jit_bf16_exact(zc, params, jbatch, jnp.int32(start))
    grads, sums = build_fused_ppo_grads(DIMS, T // 2, **KW)(theta, batch, start)
    _check_metrics(sums, jm, T // 2 * B * N)
    assert_leaves_close(grads, jg, GRAD_TOL)


def test_k4_window_equals_sliced_copy(case):
    """A window read in place gives what its copied-out rows give."""
    _, theta, batch, _ = case
    k4 = build_fused_ppo_grads(DIMS, 2, **KW)
    for start in (0, 1, T - 1):
        rows = [(start + t) % T for t in range(2)]
        window = tuple(x[rows].contiguous() for x in batch)
        g1, s1 = k4(theta, batch, start)
        g2, s2 = k4(theta, window, 0)
        torch.testing.assert_close(g1, g2, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(s1, s2, rtol=1e-6, atol=1e-6)


def _phase_inputs(theta, batch, anneal=False):
    cfg = ippo.IPPOConfig(epochs=2, minibatches=2, anneal_lr=anneal, total_updates=3)
    gen = torch.Generator().manual_seed(5)
    starts = phase_window_starts(cfg, T, phase_time_block(T // 2), gen)
    advstats = phase_advstats(batch[4], starts, T // 2)
    hyper = ippo.adam_hyper(cfg, 3, 4)
    return cfg, starts, advstats, hyper


def test_k3_plain_matches_jax(case):
    params, theta, batch, jbatch = case
    cfg, starts, advstats, hyper = _phase_inputs(theta, batch)
    p = cfg.epochs * cfg.minibatches
    update = jax_phase(dataset_len=T, epochs=2, minibatches=2, max_grad_norm=0.5,
                       interpret=True, **JAX_KW)
    arrays = jax_native._params_to_arrays(params)
    zeros = [jnp.zeros_like(a) for a in arrays]
    jw, jmu, jnu, jmets = jit_bf16_exact(update, arrays, zeros, zeros, jbatch,
                                         jnp.asarray(starts.numpy(), jnp.int32),
                                         jnp.asarray(advstats.numpy()),
                                         jnp.asarray(hyper.numpy()))
    k3 = build_fused_ppo_update_phase(DIMS, T, 2, 2, max_grad_norm=0.5, **KW)
    zero = torch.zeros_like(theta)
    w, mu, nu, mets = k3(theta, zero, zero, batch, starts, advstats, hyper)
    assert k3.launches == 0

    def flat(arrays):
        return pack_arrays([torch.from_numpy(np.array(a)) for a in arrays])

    lr = float(hyper[0, 0])
    np.testing.assert_allclose(w.numpy(), flat(jw).numpy(), atol=0.05 * lr * p, rtol=1e-3)
    for got, want in ((mu, flat(jmu)), (nu, flat(jnu))):
        for g, r in zip(DIMS.split(got), DIMS.split(want)):
            np.testing.assert_allclose(g.numpy(), r.numpy(),
                                       atol=2e-2 * float(r.abs().max()))
    n = T // 2 * B * N
    got, want = metric_means(mets, n), metric_means(torch.from_numpy(np.array(jmets)), n)
    for k in ippo.METRIC_KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-2, atol=1e-3,
                                   err_msg=k)


@pytest.mark.parametrize("anneal", [False, True])
def test_k3_plain_matches_per_pass_path(case, anneal):
    """The update phase (window advantage stats from per-time-row moments)
    against the per-pass path (K4 plain, each window's own std, then the
    optimizer step) on the same windows: the bounds of
    ``test_pallas_update.py:289-298``, with equal optimizer counts."""
    _, theta, batch, _ = case
    cfg = ippo.IPPOConfig(epochs=2, minibatches=2, anneal_lr=anneal, total_updates=3)
    opt = ippo.AdamState(3, torch.full_like(theta, 1e-3), torch.full_like(theta, 1e-6))
    data = tuple(x.contiguous() for x in batch)
    update = build_fused_ppo_update_phase(DIMS, T, 2, 2, max_grad_norm=cfg.max_grad_norm, **KW)
    grads = build_fused_ppo_grads(DIMS, T // 2, **KW)
    out = {}
    for name, fn in (("phase", lambda g: ppo_update_phase_fused(cfg, theta, opt, data, g,
                                                                   update)),
                     ("passes", lambda g: ppo_update_epochs_native(cfg, theta, opt, data, g,
                                                                   grads))):
        out[name] = fn(torch.Generator().manual_seed(7))
    (wa, oa), ma = out["phase"]
    (wb, ob), mb = out["passes"]
    assert oa.count == ob.count == 3 + 4
    np.testing.assert_allclose(wa.numpy(), wb.numpy(), rtol=2e-4, atol=2e-6)
    for k in ippo.METRIC_KEYS:
        np.testing.assert_allclose(float(ma[k]), float(mb[k]), rtol=2e-3, atol=1e-5, err_msg=k)


def test_phase_window_starts_follow_jax_rule():
    cfg = ippo.IPPOConfig(epochs=3, minibatches=4)
    starts = phase_window_starts(cfg, 32, phase_time_block(8), torch.Generator().manual_seed(0))
    assert starts.shape == (12,)
    per_epoch = starts.reshape(3, 4)
    assert bool((per_epoch % 4 == per_epoch[:, :1] % 4).all())
    # each epoch's windows tile the trajectory once
    for row in per_epoch.tolist():
        covered = sorted((s + t) % 32 for s in row for t in range(8))
        assert covered == list(range(32))
    assert [phase_time_block(t) for t in (32, 6, 3)] == [4, 2, 1]


def test_wrappers_check_inputs(case):
    _, theta, batch, _ = case
    k4 = build_fused_ppo_grads(DIMS, 2, **KW)
    with pytest.raises(ValueError):
        k4(theta[:-1], batch, 0)
    with pytest.raises(ValueError):
        k4(theta, (batch[0].float(),) + batch[1:], 0)
    with pytest.raises(ValueError):
        k4(theta, tuple(x[:1] for x in batch), 0)
    with pytest.raises(ValueError):
        build_fused_ppo_update_phase(DIMS, 6, 1, 4, max_grad_norm=0.5, **KW)
    meta = theta.to("meta")
    with pytest.raises(ValueError):
        k4(meta, tuple(x.to("meta") for x in batch), 0)
    # every registered FLATTENED sensor range fits the kernel's shared
    # memory; from sensor range 5 dense_0's weights are read from device memory
    for sr in (1, 2, 3, 4, 5):
        cfg = rware_tpu_torch.parse_env_id("rware-" + f"{sr}s-" * (sr > 1) + "tiny-2ag-v2")
        dims = type(DIMS)(cfg.flattened_obs_length, 128, 128, 5)
        k4 = build_fused_ppo_grads(dims, 4, **KW)
        assert k4.w0_smem == (sr < 5) and k4.tile >= 8
