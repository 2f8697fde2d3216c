"""The plain versions of MAPPO's fused kernels — K6 (``FusedCriticValues``),
K5 (``FusedMappoGrads``, with and without the actor) and K7
(``FusedMappoUpdatePhase``) — against the JAX Pallas kernels in interpret
mode, as ``tests/test_pallas_update.py`` runs them, and against the port's
own per-pass path.  The CUDA kernels run only on a GPU
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

The JAX side is compiled without XLA's excess precision
(``tests/torch_ref.compile_bf16_exact``): both sides then round to bf16 at
the same places and differ by float32 summation order.  The JAX kernels take
the critic's dense_0 with its rows permuted to their feature-major order
(``_critic_perm``); the port keeps flax's order, so the comparison goes
through the flax pytrees.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rware_tpu.models import ippo_pallas as jax_native
from rware_tpu.models import mappo as jax_mappo
from rware_tpu.ops.pallas_update import _critic_perm
from rware_tpu.ops.pallas_update import build_fused_critic_values as jax_values
from rware_tpu.ops.pallas_update import build_fused_mappo_grads as jax_grads
from rware_tpu.ops.pallas_update import build_fused_mappo_update_phase as jax_phase
from rware_tpu_torch.convert import critic_params_from_flax, params_from_flax
from rware_tpu_torch.models import ippo, mappo
from rware_tpu_torch.models.ippo_fused import (
    phase_advstats,
    phase_window_starts,
    ppo_update_epochs_native,
)
from rware_tpu_torch.models.networks import pack_arrays
from rware_tpu_torch.ops.fused_mappo import (
    build_fused_critic_values,
    build_fused_mappo_grads,
    build_fused_mappo_update_phase,
)
from rware_tpu_torch.ops.fused_update import metric_means, phase_time_block
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
from tests.test_torch_mappo import (
    CDIMS,
    assert_critic_leaves_close,
    assert_values_close,
    flax_critic_params,
)
from tests.torch_ref import compile_bf16_exact, jit_bf16_exact

torch.set_num_threads(1)

KW = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01)
JAX_KW = dict(obs_len=L, hidden=(128, 128), n_actions=5, n_agents=N, mb_rows=RB, **KW)
T_MB = 3  # a window of 3 of the 4 rows: time block 1, so start 3 wraps
PARTS = ("actor", "critic")


@pytest.fixture(scope="module")
def case():
    params = {"actor": flax_params(0), "critic": flax_critic_params(1, noise=0.02)}
    np_params = jax.tree.map(np.asarray, params)
    theta = {"actor": params_from_flax(np_params["actor"]),
             "critic": critic_params_from_flax(np_params["critic"])}
    batch = make_batch(1)
    jbatch = (to_native(batch[0]).astype(jnp.bfloat16),) + tuple(map(to_native, batch[1:]))
    return params, theta, torch_batch(batch), jbatch


def _check_metrics(sums, jax_metrics, n, keys=ippo.METRIC_KEYS):
    got = metric_means(sums, n)
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(jax_metrics[k]), err_msg=k,
                                   **METRIC_TOL)


def test_k6_plain_matches_jax(case):
    """Values within 1e-5 on at least 98% of the rows; nowhere further than
    a flipped bf16 rounding of one hidden unit (2e-3)."""
    params, theta, batch, jbatch = case
    vfn = jax_values(obs_len=L, n_agents=N, rollout_len=T, mb_rows=RB, interpret=True)
    want = jit_bf16_exact(vfn, params["critic"], jbatch[0])
    k6 = build_fused_critic_values(CDIMS)
    got = k6(theta["critic"], batch[0])
    assert k6.launches == 0  # CPU tensors take the plain version
    assert got.shape == (T, B, N) and got.dtype == torch.float32
    assert_values_close(np.asarray(to_native(got.numpy())), want)


@pytest.fixture(scope="module")
def jax_window_grads(case):
    """JAX's zero-copy K5 over a T_MB-row window, compiled once per mode."""
    params, _, _, jbatch = case
    kw = dict(rollout_len=T_MB, dataset_len=T, interpret=True, **JAX_KW)
    both = compile_bf16_exact(jax_grads(**kw), params, jbatch, jnp.int32(0))
    cbatch = (jbatch[0], jbatch[3], jbatch[5])
    critic = compile_bf16_exact(jax_grads(with_actor=False, **kw), params["critic"], cbatch,
                                jnp.int32(0))
    return both, critic


@pytest.mark.parametrize("start", [0, phase_time_block(T_MB), T - phase_time_block(T_MB)])
def test_k5_plain_matches_jax(case, jax_window_grads, start):
    """Both parts' gradients within 5% of each leaf's largest entry (the JAX
    tests' bound; the measured difference is far smaller), metrics to rtol
    2e-2, and exactly zero for the actor's local value head."""
    params, theta, batch, jbatch = case
    jg, jm = jax_window_grads[0](params, jbatch, jnp.int32(start))
    k5 = build_fused_mappo_grads(DIMS, CDIMS, T_MB, **KW)
    grads, sums = k5(theta, batch, start)
    assert k5.launches == 0
    _check_metrics(sums, jm, T_MB * B * N)
    assert_leaves_close(grads["actor"], jg["actor"], GRAD_TOL)
    assert_critic_leaves_close(grads["critic"], jg["critic"], GRAD_TOL)
    blocks = DIMS.split(grads["actor"])
    assert float(blocks[4][:, DIMS.n_actions].abs().max()) == 0.0
    assert float(blocks[5][0, DIMS.n_actions].abs()) == 0.0
    assert float(np.abs(np.asarray(jg["actor"]["params"]["value"]["kernel"])).max()) == 0.0


def test_k5_plain_is_tighter_than_the_jax_bound(case, jax_window_grads):
    """The same comparison at 1e-2 of each leaf's largest entry, on a window
    that wraps."""
    params, theta, batch, jbatch = case
    jg, _ = jax_window_grads[0](params, jbatch, jnp.int32(T - 1))
    grads, _ = build_fused_mappo_grads(DIMS, CDIMS, T_MB, **KW)(theta, batch, T - 1)
    assert_leaves_close(grads["actor"], jg["actor"], 1e-2)
    assert_critic_leaves_close(grads["critic"], jg["critic"], 1e-2)


@pytest.mark.parametrize("start", [0, phase_time_block(T_MB), T - phase_time_block(T_MB)])
def test_k5_critic_only_plain_matches_jax(case, jax_window_grads, start):
    params, theta, batch, jbatch = case
    cbatch = (jbatch[0], jbatch[3], jbatch[5])
    jg, jm = jax_window_grads[1](params["critic"], cbatch, jnp.int32(start))
    k5c = build_fused_mappo_grads(None, CDIMS, T_MB, with_actor=False, **KW)
    cdata = (batch[0], batch[3], batch[5])
    grads, sums = k5c(theta["critic"], cdata, start)
    assert k5c.launches == 0
    _check_metrics(sums, jm, T_MB * B * N, keys=("v_loss",))
    assert float(sums[0]) == float(sums[2]) == float(sums[3]) == 0.0
    assert_critic_leaves_close(grads, jg, 1e-2)
    # the critic-only variant gives what the combined one gives for the critic
    both, both_sums = build_fused_mappo_grads(DIMS, CDIMS, T_MB, **KW)(theta, batch, start)
    torch.testing.assert_close(grads, both["critic"], rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(sums[1], both_sums[1], rtol=1e-6, atol=1e-6)


def test_k5_window_equals_sliced_copy(case):
    """A window read in place gives what its copied-out rows give."""
    _, theta, batch, _ = case
    k5 = build_fused_mappo_grads(DIMS, CDIMS, 2, **KW)
    for start in (0, 1, T - 1):
        rows = [(start + t) % T for t in range(2)]
        window = tuple(x[rows].contiguous() for x in batch)
        g1, s1 = k5(theta, batch, start)
        g2, s2 = k5(theta, window, 0)
        for part in PARTS:
            torch.testing.assert_close(g1[part], g2[part], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(s1, s2, rtol=1e-6, atol=1e-6)


def _phase_inputs(batch):
    cfg = ippo.IPPOConfig(epochs=2, minibatches=2)
    starts = phase_window_starts(cfg, T, phase_time_block(T // 2),
                                 torch.Generator().manual_seed(5))
    advstats = phase_advstats(batch[4], starts, T // 2)
    hyper = ippo.adam_hyper(cfg, 3, 4)
    return cfg, starts, advstats, hyper


def test_k7_plain_matches_jax(case):
    """Both parts' parameters to ``atol = 0.05 * lr * P``, ``rtol = 1e-3``;
    moments within 2e-2 of each block's largest entry; the (P, 4) metrics to
    rtol 1e-2."""
    params, theta, batch, jbatch = case
    cfg, starts, advstats, hyper = _phase_inputs(batch)
    p = cfg.epochs * cfg.minibatches
    update = jax_phase(dataset_len=T, epochs=2, minibatches=2, max_grad_norm=0.5,
                       interpret=True, **JAX_KW)
    perm, inv_perm = _critic_perm(L, N)
    a_arrays = jax_native._params_to_arrays(params["actor"])
    c_arrays = jax_mappo._critic_params_to_arrays(params["critic"], perm)
    a_zero = [jnp.zeros_like(a) for a in a_arrays]
    c_zero = [jnp.zeros_like(a) for a in c_arrays]
    out = jit_bf16_exact(update, a_arrays, a_zero, a_zero, c_arrays, c_zero, c_zero, jbatch,
                         jnp.asarray(starts.numpy(), jnp.int32), jnp.asarray(advstats.numpy()),
                         jnp.asarray(hyper.numpy()))
    k7 = build_fused_mappo_update_phase(DIMS, CDIMS, T, 2, 2, max_grad_norm=0.5, **KW)
    zero = {k: torch.zeros_like(v) for k, v in theta.items()}
    w, mu, nu, mets = k7(theta, zero, zero, batch, starts, advstats, hyper)
    assert k7.launches == 0

    def flat(arrays, critic):
        arrays = [np.array(a) for a in arrays]
        if critic:  # back to flax's agent-major dense_0 rows
            arrays[0] = arrays[0][np.asarray(inv_perm)]
        return pack_arrays([torch.from_numpy(a) for a in arrays])

    lr = float(hyper[0, 0])
    for i, (part, dims) in enumerate((("actor", DIMS), ("critic", CDIMS))):
        jw, jmu, jnu = (flat(out[3 * i + j], critic=i == 1) for j in range(3))
        np.testing.assert_allclose(w[part].numpy(), jw.numpy(), atol=0.05 * lr * p, rtol=1e-3,
                                   err_msg=part)
        assert float((w[part] - theta[part]).abs().max()) > 0
        for got, want in ((mu[part], jmu), (nu[part], jnu)):
            for g, r in zip(dims.split(got), dims.split(want)):
                np.testing.assert_allclose(g.numpy(), r.numpy(),
                                           atol=2e-2 * float(r.abs().max()), err_msg=part)
    n = T // 2 * B * N
    got, want = metric_means(mets, n), metric_means(torch.from_numpy(np.array(out[6])), n)
    assert mets.shape == (p, 4)
    for k in ippo.METRIC_KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-2, atol=1e-3,
                                   err_msg=k)


def test_k7_plain_matches_per_pass_path(case):
    """The update phase (window advantage stats from per-time-row moments,
    the actor's count for both parts) against the per-pass path (K5 plain,
    each window's own std, then the split optimizer step) on the same
    windows, with equal optimizer counts on both parts."""
    _, theta, batch, _ = case
    cfg = ippo.IPPOConfig(epochs=2, minibatches=2)
    opt = {k: ippo.AdamState(3, torch.full_like(v, 1e-3), torch.full_like(v, 1e-6))
           for k, v in theta.items()}
    update = build_fused_mappo_update_phase(DIMS, CDIMS, T, 2, 2,
                                            max_grad_norm=cfg.max_grad_norm, **KW)
    grads = build_fused_mappo_grads(DIMS, CDIMS, T // 2, **KW)
    (wa, oa), ma = mappo.mappo_update_phase_fused(cfg, theta, opt, batch,
                                                  torch.Generator().manual_seed(7), update)
    (wb, ob), mb = ppo_update_epochs_native(cfg, theta, opt, batch,
                                            torch.Generator().manual_seed(7), grads,
                                            step_fn=mappo.mappo_optimizer_step)
    for part in PARTS:
        assert oa[part].count == ob[part].count == 3 + 4
        np.testing.assert_allclose(wa[part].numpy(), wb[part].numpy(), rtol=2e-4, atol=2e-6)
        assert opt[part].count == 3  # the input state is untouched
    for k in ippo.METRIC_KEYS:
        np.testing.assert_allclose(float(ma[k]), float(mb[k]), rtol=2e-3, atol=1e-5, err_msg=k)


def test_each_part_is_clipped_by_its_own_norm(case):
    """A large critic gradient (targets far from the values) is clipped
    without shrinking the actor's step: the actor moves as it does beside a
    small critic gradient."""
    _, theta, batch, _ = case
    cfg, starts, advstats, hyper = _phase_inputs(batch)
    k7 = build_fused_mappo_update_phase(DIMS, CDIMS, T, 2, 2, max_grad_norm=0.5, **KW)
    zero = {k: torch.zeros_like(v) for k, v in theta.items()}
    far = batch[:5] + (batch[5] * 100.0,)
    w_near, _, _, _ = k7(theta, zero, zero, batch, starts[:1].repeat(4), advstats[:1].repeat(4, 1),
                         hyper)
    w_far, _, _, _ = k7(theta, zero, zero, far, starts[:1].repeat(4), advstats[:1].repeat(4, 1),
                        hyper)
    assert torch.equal(w_near["actor"], w_far["actor"])
    assert not torch.equal(w_near["critic"], w_far["critic"])


def test_wrappers_check_inputs(case):
    _, theta, batch, _ = case
    k5 = build_fused_mappo_grads(DIMS, CDIMS, 2, **KW)
    k6 = build_fused_critic_values(CDIMS)
    with pytest.raises(ValueError):
        k5({"actor": theta["actor"], "critic": theta["critic"][:-1]}, batch, 0)
    with pytest.raises(ValueError):
        k5(theta, (batch[0].float(),) + batch[1:], 0)
    with pytest.raises(ValueError):
        k5(theta, tuple(x[:1] for x in batch), 0)
    with pytest.raises(ValueError):
        k6(theta["critic"], batch[0].float())
    with pytest.raises(ValueError):
        k6(theta["critic"], batch[0][:, :, :1])
    with pytest.raises(ValueError):
        k6(theta["critic"].to("meta"), batch[0].to("meta"))
    with pytest.raises(ValueError):
        k5({k: v.to("meta") for k, v in theta.items()}, tuple(x.to("meta") for x in batch), 0)
    with pytest.raises(ValueError):
        build_fused_mappo_update_phase(DIMS, CDIMS, 6, 1, 4, max_grad_norm=0.5, **KW)
    with pytest.raises(ValueError):
        build_fused_mappo_grads(DIMS, type(CDIMS)(N, L + 1, 128, 128), 2, **KW)


@pytest.mark.parametrize("env_id,w0_smem", [
    ("rware-tiny-2ag-v2", True), ("rware-small-4ag-v2", True), ("rware-large-8ag-v2", True),
    ("rware-tiny-16ag-v2", False), ("rware-3s-tiny-2ag-v2", False),
    ("rware-img-tiny-2ag-v2", True)])
def test_critic_dense0_leaves_shared_memory_where_it_does_not_fit(env_id, w0_smem):
    """The critic's dense_0 (N*L, CH1) in bf16 stays in a block's shared
    memory where it fits beside a tile of samples; else the kernel reads it
    from device memory."""
    import rware_tpu_torch
    from rware_tpu_torch.ops.fused_update import SMEM_LIMIT, sample_smem

    cfg = rware_tpu_torch.parse_env_id(env_id)
    cdims = type(CDIMS)(cfg.n_agents, cfg.policy_obs_length, 128, 128)
    k6 = build_fused_critic_values(cdims)
    assert k6.w0_smem == w0_smem and k6.tile >= 8
    n = cdims.n_agents
    assert sample_smem(cdims.joint_len, 128, 128, n, n, k6.tile, k6.w0_smem) <= SMEM_LIMIT
