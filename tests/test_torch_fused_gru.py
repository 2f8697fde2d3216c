"""The plain versions of the GRU sequence kernels (K9 forward, K10 backward)
against the JAX package's ``build_gru_obs_fwd`` / ``build_gru_obs_bwd`` in
interpret mode, on the CPU, and ``GruObsScan`` against torch autograd of the
per-step replay.

The port's functions read an env band of the whole ``(T, B, N, ...)``
trajectory in place; the JAX kernels take the band already cut out, in their
``(T, N, RB, LANE, ...)`` layout.  The case: T=8, N=2, 384 envs of which a
band of 256 that wraps (envs 256..383, then 0..127), Hg=16, E=12, L=31,
``done`` at 20%, a nonzero initial hidden, nonzero biases.

Tolerances.  ``hseq``: equal to the bit, or one bf16 step (2**-7) on at most
0.1% of the entries (a float32 sum taken in another order crosses a rounding
boundary now and then).  Gradients: within 1e-2 of the block's largest
|reference| (cotangents are rounded to bf16, 2**-9 relative, before each
product).  ``GruObsScan`` against autograd: 3e-2 of the block's largest, the
bound of ``tests/test_pallas_gru.py:79``; autograd differentiates the
unrounded gates where the kernel's algebra rounds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rware_tpu.ops.pallas_gru import build_gru_obs_bwd, build_gru_obs_fwd
from rware_tpu.ops.pallas_rollout import LANE
from rware_tpu_torch.models import networks as nets
from rware_tpu_torch.ops.fused_gru import (
    GruObsScan,
    band_index,
    build_fused_gru_obs_bwd,
    build_fused_gru_obs_fwd,
)
from tests.torch_ref import jit_bf16_exact

torch.set_num_threads(1)

T_LEN, N, B, L, E, HG = 8, 2, 384, 31, 12, 16
START, N_ENV = 256, 256
BF16_STEP = 2.0 ** -7
BLOCKS = ("dWe", "dbe", "dWi", "dbi", "dWh", "dbhn")


def bf16_values(x):
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    dims = nets.GruDims(L, E, HG, 5)
    weights = [(rng.standard_normal(s) * (0.3 if s[0] == 1 else s[0] ** -0.5)).astype(np.float32)
               for s in dims.shapes[:6]]
    obs = (rng.integers(0, 3, (T_LEN, B, N, L)) * 0.5).astype(np.float32)
    done = rng.random((T_LEN, B)) < 0.2
    h0 = bf16_values(rng.uniform(-1, 1, (B, N, HG)))
    dh = bf16_values(rng.standard_normal((T_LEN, N_ENV, N, HG)) * 1e-2)
    return dict(dims=dims, weights=weights, obs=obs, done=done, h0=h0, dh=dh)


def to_jax_band(x, env_axis):
    """Cut the band out of a (.., B, ..) array and lay its envs out as (RB, LANE)."""
    idx = (START + np.arange(N_ENV)) % B
    x = np.take(x, idx, axis=env_axis)
    shape = x.shape[:env_axis] + (N_ENV // LANE, LANE) + x.shape[env_axis + 1:]
    return x.reshape(shape)


def from_jax_seq(x):
    """(T, N, RB, LANE, H) -> (T, n_env, N, H)."""
    x = np.asarray(x.astype(jnp.float32))
    return x.transpose(0, 2, 3, 1, 4).reshape(x.shape[0], N_ENV, N, x.shape[-1])


@pytest.fixture(scope="module")
def jax_side(case):
    we, be, wi, bi, wh, bhn = (jnp.asarray(w) for w in case["weights"])
    args = (we, be[0], wi, bi[0], wh.astype(jnp.bfloat16), bhn[0])
    obs = jnp.asarray(to_jax_band(case["obs"], 1).transpose(0, 3, 1, 2, 4), jnp.bfloat16)
    done = jnp.asarray(to_jax_band(case["done"], 1)[:, None].astype(np.float32))
    h0 = jnp.asarray(to_jax_band(case["h0"], 0).transpose(2, 0, 1, 3), jnp.bfloat16)
    rb = N_ENV // LANE
    fwd = build_gru_obs_fwd(T_LEN, N, rb, HG, E, L, interpret=True)
    bwd = build_gru_obs_bwd(T_LEN, N, rb, HG, E, L, interpret=True)
    hseq = jit_bf16_exact(fwd, *args, obs, done, h0)
    dh = jnp.asarray(case["dh"].reshape(T_LEN, rb, LANE, N, HG).transpose(0, 3, 1, 2, 4),
                     jnp.bfloat16)
    grads = jit_bf16_exact(bwd, *args, obs, done, h0, hseq, dh)
    dh0 = np.asarray(grads[6]).transpose(1, 2, 0, 3).reshape(N_ENV, N, HG)
    return dict(hseq=from_jax_seq(hseq), grads=[np.asarray(g) for g in grads[:6]], dh0=dh0)


@pytest.fixture(scope="module")
def port_side(case, jax_side):
    weights = [torch.from_numpy(w) for w in case["weights"]]
    obs = torch.from_numpy(case["obs"]).to(torch.bfloat16)
    done, h0 = torch.from_numpy(case["done"]), torch.from_numpy(case["h0"]).to(torch.bfloat16)
    fwd, bwd = build_fused_gru_obs_fwd(case["dims"]), build_fused_gru_obs_bwd(case["dims"])
    hseq = fwd(weights, obs, done, h0, START, N_ENV)
    # K10 from the reference's hidden sequence, so that the comparison is of K10 alone
    jh = torch.from_numpy(jax_side["hseq"]).to(torch.bfloat16)
    dh = torch.from_numpy(case["dh"]).to(torch.bfloat16)
    grads, dh0 = bwd(weights, obs, done, h0, jh, dh, START, N_ENV)
    return dict(weights=weights, obs=obs, done=done, h0=h0, fwd=fwd, bwd=bwd, hseq=hseq,
                grads=grads, dh0=dh0, dh=dh)


def test_hseq_matches_the_forward_kernel(port_side, jax_side):
    got = port_side["hseq"]
    assert got.dtype == torch.bfloat16 and got.shape == (T_LEN, N_ENV, N, HG)
    diff = np.abs(got.float().numpy() - jax_side["hseq"])
    assert diff.max() <= BF16_STEP + 1e-6, diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()
    assert port_side["fwd"].launches == 0  # CPU tensors: the plain version


def test_hseq_is_the_hidden_before_the_reset(port_side):
    """Where done[t], hseq[t] is still the step's output and step t+1 starts from zero."""
    w, obs, done, h0 = (port_side[k] for k in ("weights", "obs", "done", "h0"))
    idx = band_index(START, N_ENV, B, "cpu")
    hseq = port_side["hseq"].float()
    t = 3
    assert bool(done[t, idx].any()) and float(hseq[t][done[t, idx]].abs().max()) > 0
    prev = torch.where(done[t, idx][:, None, None], torch.zeros(()), hseq[t])
    want = nets.gru_replay_step(w, prev, obs[t + 1, idx])
    assert torch.equal(want, hseq[t + 1])


@pytest.mark.parametrize("k", range(6), ids=BLOCKS)
def test_gradient_matches_the_backward_kernel(port_side, jax_side, k):
    got = port_side["bwd"].split(port_side["grads"])[k].numpy()
    want = jax_side["grads"][k].reshape(got.shape)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max(), \
        (np.abs(got - want).max(), np.abs(want).max())


def test_dh0_matches_the_backward_kernel(port_side, jax_side):
    got, want = port_side["dh0"].numpy(), jax_side["dh0"]
    assert got.shape == (N_ENV, N, HG) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_the_adjoint_is_cut_at_done(port_side):
    """A cotangent at the last step alone reaches dh0 only in envs with no
    ``done`` before it."""
    w, obs, done, h0 = (port_side[k] for k in ("weights", "obs", "done", "h0"))
    hseq = port_side["hseq"]
    dh = torch.zeros_like(hseq)
    dh[-1] = 1.0
    _, dh0 = port_side["bwd"](w, obs, done, h0, hseq, dh, START, N_ENV)
    idx = band_index(START, N_ENV, B, "cpu")
    cut = done[:-1, idx].any(0)
    assert bool(cut.any()) and bool((~cut).any())
    assert float(dh0[cut].abs().max()) == 0.0
    assert float(dh0[~cut].abs().max()) > 0.0


@pytest.mark.parametrize("k", range(6), ids=BLOCKS)
def test_gru_obs_scan_against_autograd(port_side, k):
    """``GruObsScan`` (plain K9 forward, plain K10 backward) against torch
    autograd of the per-step replay."""
    w, obs, done, h0 = (port_side[k_] for k_ in ("weights", "obs", "done", "h0"))
    g = port_side["dh"].float()
    a = [x.clone().requires_grad_(True) for x in w]
    hseq = GruObsScan.apply(*a, obs, done, h0, START, N_ENV, port_side["fwd"], port_side["bwd"])
    (hseq.float() * g).sum().backward()
    b = [x.clone().requires_grad_(True) for x in w]
    idx = band_index(START, N_ENV, B, "cpu")
    h, outs = h0[idx].float(), []
    for t in range(T_LEN):
        new_h = nets.gru_replay_step(b, h, obs[t, idx])
        outs.append(new_h)
        h = torch.where(done[t, idx][:, None, None], torch.zeros_like(new_h), new_h)
    ref = torch.stack(outs)
    assert torch.equal(ref.detach(), hseq.detach().float())
    (ref * g).sum().backward()
    err, top = float((a[k].grad - b[k].grad).abs().max()), float(b[k].grad.abs().max())
    assert err <= 3e-2 * top, (err, top)
    if k == 4:  # Wh enters the scan in bf16: its gradient is bf16-exact
        assert torch.equal(a[k].grad, a[k].grad.to(torch.bfloat16).float())


def test_bands_tile_the_batch(port_side):
    """Two half bands give the rows of the whole-batch call, and the
    gradients of disjoint bands add up (float32 sums in another order)."""
    w, obs, done, h0, fwd, bwd = (port_side[k] for k in
                                  ("weights", "obs", "done", "h0", "fwd", "bwd"))
    whole = fwd(w, obs, done, h0, 0, B)
    a, b = fwd(w, obs, done, h0, 0, 128), fwd(w, obs, done, h0, 128, 256)
    assert torch.equal(torch.cat([a, b], 1), whole)
    wrapped = fwd(w, obs, done, h0, 300, 200)
    idx = band_index(300, 200, B, "cpu")
    assert torch.equal(wrapped, whole[:, idx])
    dh = torch.ones_like(whole) * 0.01
    g_whole, _ = bwd(w, obs, done, h0, whole, dh, 0, B)
    g_a, _ = bwd(w, obs, done, h0, a, dh[:, :128], 0, 128)
    g_b, _ = bwd(w, obs, done, h0, b, dh[:, 128:], 128, 256)
    np.testing.assert_allclose((g_a + g_b).numpy(), g_whole.numpy(), atol=1e-4, rtol=1e-4)


def test_wrappers_check_their_arguments(port_side):
    w, obs, done, h0, fwd, bwd = (port_side[k] for k in
                                  ("weights", "obs", "done", "h0", "fwd", "bwd"))
    with pytest.raises(ValueError, match="obs must be bf16"):
        fwd(w, obs.float(), done, h0, 0, 8)
    with pytest.raises(ValueError, match="band"):
        fwd(w, obs, done, h0, B, 8)
    with pytest.raises(ValueError, match="band"):
        fwd(w, obs, done, h0, 0, B + 1)
    with pytest.raises(ValueError, match="weights have shapes"):
        fwd(w[:5] + [w[5].t()], obs, done, h0, 0, 8)
    with pytest.raises(ValueError, match="h0 must be bf16"):
        fwd(w, obs, done, h0.float(), 0, 8)
    with pytest.raises(ValueError, match="dhseq must be bf16"):
        bwd(w, obs, done, h0, port_side["hseq"], port_side["dh"].float(), START, N_ENV)
    assert bwd.n_grads == (L + 1) * E + (E + 1) * 3 * HG + HG * 3 * HG + HG
