"""The plain versions of the iall-fed GRU sequence kernels (K11 forward, K12
backward, K13 loss-fused backward) against the JAX package's
``build_gru_seq_fwd`` / ``build_gru_seq_bwd`` / ``build_gru_loss_bwd`` in
interpret mode, on the CPU; ``GruSeqScan`` against torch autograd of the
plain recurrence; the port's ``rnn_fused_grads`` against JAX's
``rnn_fused_grads(interpret=True)`` and against autograd of the port's
``rnn_ppo_loss_native``.

The case, at ``tests/test_pallas_gru.py``'s size: T=8, N=2, Hg=16, a band
of 256 envs (two rows of 128) that wraps in a batch of 384 (envs 256..383,
then 0..127), ``done`` at 25%, a nonzero initial hidden, nonzero biases.
The port reads ``done``, ``h0`` and the per-sample streams through the band;
the JAX kernels take the band cut out, in their ``(T, N, RB, LANE, ...)``
layout.

Tolerances.  ``hseq``: within one bf16 step (2**-7), with at most 0.1% of
the entries differing (the bound of ``tests/test_torch_fused_gru.py``: a
float32 sum taken in another order crosses a rounding boundary now and
then).  Gradients, ``d_iall`` and ``dh0``: within 1e-2 of each block's
largest |reference| (cotangents are rounded to bf16 before each product);
metric sums within rtol 1e-3.  ``GruSeqScan`` against autograd: 3e-2 of the
block's largest (``tests/test_pallas_gru.py:79``); ``rnn_fused_grads``
against autograd of the loss: 0.06 of the block's largest, JAX's own bound
for the same comparison (``tests/test_pallas_gru.py:128-184``: the fused
heads are float32, the replay's bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rware_tpu.models import IPPOConfig as JaxConfig
from rware_tpu.models import ippo_rnn as jax_rnn
from rware_tpu.models.networks import RecurrentActorCritic as FlaxRecurrent
from rware_tpu.ops.pallas_gru import build_gru_loss_bwd, build_gru_seq_bwd, build_gru_seq_fwd
from rware_tpu.ops.pallas_rollout import LANE
from rware_tpu_torch.convert import gru_params_from_flax
from rware_tpu_torch.models import ippo, ippo_rnn
from rware_tpu_torch.models import networks as nets
from rware_tpu_torch.models.ppo import loss_grads
from rware_tpu_torch.ops.fused_gru import (
    GruSeqScan,
    band_index,
    build_fused_gru_loss_bwd,
    build_fused_gru_obs_bwd,
    build_fused_gru_obs_fwd,
    build_fused_gru_seq_bwd,
    build_fused_gru_seq_fwd,
)
from tests.torch_ref import jit_bf16_exact

torch.set_num_threads(1)

T_LEN, N, HG, A, L, E = 8, 2, 16, 5, 31, 16
B, START, N_ENV = 384, 256, 256
RB = N_ENV // LANE
BF16_STEP = 2.0 ** -7
CFG = ippo.IPPOConfig()  # clip 0.2, vf 0.5, ent 0.01: JAX's defaults
METRICS = ("pg_loss", "v_loss", "entropy", "approx_kl")


def bf16_values(x):
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def band(x, env_axis):
    return np.take(x, (START + np.arange(N_ENV)) % B, axis=env_axis)


def seq_to_jax(x):
    """(T, n_env, N, C) -> (T, N, RB, LANE, C)."""
    return x.reshape(x.shape[0], RB, LANE, N, x.shape[-1]).transpose(0, 3, 1, 2, 4)


def seq_from_jax(x):
    """(T, N, RB, LANE, C) -> (T, n_env, N, C)."""
    x = np.array(jnp.asarray(x).astype(jnp.float32))
    return x.transpose(0, 2, 3, 1, 4).reshape(x.shape[0], N_ENV, N, x.shape[-1])


def small_to_jax(x):
    """(T, B, N) -> the band as (T, N, RB, LANE)."""
    return band(x, 1).reshape(x.shape[0], RB, LANE, N).transpose(0, 3, 1, 2)


def h0_to_jax(x):
    return band(x, 0).reshape(RB, LANE, N, HG).transpose(2, 0, 1, 3)


def dh0_from_jax(x):
    return np.asarray(x).transpose(1, 2, 0, 3).reshape(N_ENV, N, HG)


def assert_block_close(got, want, frac, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= frac * top, (what, err, top)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    adv = rng.standard_normal((T_LEN, B, N)).astype(np.float32)
    advb = band(adv, 1)
    return dict(
        wh=(rng.standard_normal((HG, 3 * HG)) * 0.3).astype(np.float32),
        bhn=(rng.standard_normal((1, HG)) * 0.1).astype(np.float32),
        iall=bf16_values(rng.standard_normal((T_LEN, N_ENV, N, 3 * HG))),
        done=rng.random((T_LEN, B)) < 0.25,
        h0=bf16_values(rng.standard_normal((B, N, HG)) * 0.5),
        dh=bf16_values(rng.standard_normal((T_LEN, N_ENV, N, HG))),
        whead=(rng.standard_normal((HG, A + 1)) * HG ** -0.5).astype(np.float32),
        bhead=(rng.standard_normal(A + 1) * 0.1).astype(np.float32),
        action=rng.integers(0, A, (T_LEN, B, N)).astype(np.int32),
        logp=(rng.standard_normal((T_LEN, B, N)) * 0.1 - 1.6).astype(np.float32),
        value=rng.standard_normal((T_LEN, B, N)).astype(np.float32),
        adv=adv,
        target=rng.standard_normal((T_LEN, B, N)).astype(np.float32),
        stats=np.array([advb.mean(), 1.0 / (advb.std() + 1e-8)], np.float32),
    )


@pytest.fixture(scope="module")
def jax_side(case):
    wh = jnp.asarray(case["wh"], jnp.bfloat16)
    bhn = jnp.asarray(case["bhn"][0])
    iall = jnp.asarray(seq_to_jax(case["iall"]), jnp.bfloat16)
    done = jnp.asarray(band(case["done"], 1).reshape(T_LEN, 1, RB, LANE).astype(np.float32))
    h0 = jnp.asarray(h0_to_jax(case["h0"]), jnp.bfloat16)
    fwd = build_gru_seq_fwd(T_LEN, N, RB, HG, interpret=True)
    hseq = jit_bf16_exact(fwd, wh, bhn, iall, done, h0)
    bwd = build_gru_seq_bwd(T_LEN, N, RB, HG, interpret=True)
    dh = jnp.asarray(seq_to_jax(case["dh"]), jnp.bfloat16)
    dwh, dbhn, d_iall, dh0 = jit_bf16_exact(bwd, wh, bhn, iall, done, h0, hseq, dh)
    loss = build_gru_loss_bwd(T_LEN, N, RB, HG, A, CFG.clip_eps, CFG.vf_coef, CFG.ent_coef,
                              interpret=True)
    streams = [jnp.asarray(small_to_jax(case[k])) for k in
               ("action", "logp", "value", "adv", "target")]
    lout = jit_bf16_exact(loss, wh, bhn, jnp.asarray(case["whead"]),
                          jnp.asarray(case["bhead"][None]), iall, done, h0, hseq, *streams,
                          jnp.asarray(case["stats"]))
    return dict(
        hseq=seq_from_jax(hseq),
        seq_bwd=dict(dwh=np.asarray(dwh), dbhn=np.asarray(dbhn).reshape(1, HG),
                     d_iall=seq_from_jax(d_iall), dh0=dh0_from_jax(dh0)),
        loss_bwd=dict(d_iall=seq_from_jax(lout[0]), dwh=np.asarray(lout[1]),
                      dbhn=np.asarray(lout[2]).reshape(1, HG), dwhead=np.asarray(lout[3]),
                      dbhead=np.asarray(lout[4])[0], dh0=dh0_from_jax(lout[5]),
                      mets=np.asarray(lout[6])),
    )


@pytest.fixture(scope="module")
def port_side(case, jax_side):
    dims = nets.GruDims(L, E, HG, A)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in case.items()}
    for k in ("iall", "h0", "dh"):
        t[k] = t[k].to(torch.bfloat16)
    fwd, bwd = build_fused_gru_seq_fwd(dims), build_fused_gru_seq_bwd(dims)
    loss = build_fused_gru_loss_bwd(dims, CFG.clip_eps, CFG.vf_coef, CFG.ent_coef)
    hseq = fwd(t["wh"], t["bhn"], t["iall"], t["done"], t["h0"], START, N_ENV)
    # the backward kernels from the reference's hidden sequence, so that each
    # comparison is of one kernel alone
    jh = torch.from_numpy(jax_side["hseq"]).to(torch.bfloat16)
    seq = (t["wh"], t["bhn"], t["iall"], t["done"], t["h0"], jh)
    dwh, dbhn, d_iall, dh0 = bwd(*seq[:5], jh, t["dh"], START, N_ENV)
    lout = loss(t["wh"], t["bhn"], t["whead"], t["bhead"], *seq[2:], t["action"], t["logp"],
                t["value"], t["adv"], t["target"], t["stats"], START, N_ENV)
    names = ("d_iall", "dwh", "dbhn", "dwhead", "dbhead", "dh0", "mets")
    return dict(t=t, dims=dims, fwd=fwd, bwd=bwd, loss=loss, hseq=hseq,
                seq_bwd=dict(dwh=dwh, dbhn=dbhn, d_iall=d_iall, dh0=dh0),
                loss_bwd=dict(zip(names, lout)))


def test_seq_forward_matches_the_kernel(port_side, jax_side):
    got = port_side["hseq"]
    assert got.dtype == torch.bfloat16 and got.shape == (T_LEN, N_ENV, N, HG)
    diff = np.abs(got.float().numpy() - jax_side["hseq"])
    assert diff.max() <= BF16_STEP + 1e-6, diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()
    assert port_side["fwd"].launches == 0  # CPU tensors: the plain version


def test_seq_forward_is_the_replay_cell_with_resets(port_side):
    """Where done[t], hseq[t] is still the step's output and step t+1 starts
    from zero; each step is ``gru_replay_cell`` on the bf16 gates."""
    t = port_side["t"]
    idx = band_index(START, N_ENV, B, "cpu")
    hseq = port_side["hseq"].float()
    step = 3
    cut = t["done"][step, idx]
    assert bool(cut.any()) and float(hseq[step][cut].abs().max()) > 0
    prev = torch.where(cut[:, None, None], torch.zeros(()), hseq[step])
    want = nets.gru_replay_cell(t["wh"], t["bhn"], prev, t["iall"][step + 1].float())
    assert torch.equal(want, hseq[step + 1])


@pytest.mark.parametrize("name", ["dwh", "dbhn", "d_iall", "dh0"])
def test_seq_backward_matches_the_kernel(port_side, jax_side, name):
    got = port_side["seq_bwd"][name]
    assert got.dtype == (torch.bfloat16 if name == "d_iall" else torch.float32)
    assert_block_close(got.float().numpy(), jax_side["seq_bwd"][name], 1e-2, name)


@pytest.mark.parametrize("name", ["d_iall", "dwh", "dbhn", "dwhead", "dbhead", "dh0"])
def test_loss_backward_matches_the_kernel(port_side, jax_side, name):
    got = port_side["loss_bwd"][name]
    assert_block_close(got.float().numpy(), jax_side["loss_bwd"][name], 1e-2, name)


def test_loss_backward_metric_sums_match_the_kernel(port_side, jax_side):
    got = port_side["loss_bwd"]["mets"].numpy()
    np.testing.assert_allclose(got, jax_side["loss_bwd"]["mets"], rtol=1e-3, atol=1e-4)
    assert port_side["loss"].launches == port_side["bwd"].launches == 0


def test_seq_backward_cuts_the_adjoint_at_done(port_side):
    """A cotangent at the last step alone reaches dh0 only in envs with no
    ``done`` before it, and d_iall only at that step in envs cut just before."""
    t, bwd = port_side["t"], port_side["bwd"]
    hseq = port_side["hseq"]
    dh = torch.zeros_like(hseq)
    dh[-1] = 1.0
    _, _, d_iall, dh0 = bwd(t["wh"], t["bhn"], t["iall"], t["done"], t["h0"], hseq, dh,
                            START, N_ENV)
    idx = band_index(START, N_ENV, B, "cpu")
    cut = t["done"][:-1, idx].any(0)
    assert bool(cut.any()) and bool((~cut).any())
    assert float(dh0[cut].abs().max()) == 0.0
    assert float(dh0[~cut].abs().max()) > 0.0
    last_cut = t["done"][-2, idx]
    assert float(d_iall[:-1][:, last_cut].float().abs().max()) == 0.0


@pytest.mark.parametrize("k", range(3), ids=["wh", "bhn", "iall"])
def test_gru_seq_scan_against_autograd(port_side, k):
    """``GruSeqScan`` (plain K11 forward, plain K12 backward) against torch
    autograd of the plain recurrence, a loop of ``gru_replay_cell``."""
    t = port_side["t"]
    g = t["dh"].float()
    wh, bhn = t["wh"].clone().requires_grad_(True), t["bhn"].clone().requires_grad_(True)
    iall = t["iall"].clone().requires_grad_(True)
    hseq = GruSeqScan.apply(wh, bhn, iall, t["done"], t["h0"], START, N_ENV, port_side["fwd"],
                            port_side["bwd"])
    (hseq.float() * g).sum().backward()
    ref_in = [t["wh"].clone().requires_grad_(True), t["bhn"].clone().requires_grad_(True),
              t["iall"].float().requires_grad_(True)]
    idx = band_index(START, N_ENV, B, "cpu")
    h, outs = t["h0"][idx].float(), []
    for step in range(T_LEN):
        new_h = nets.gru_replay_cell(ref_in[0], ref_in[1], h, ref_in[2][step])
        outs.append(new_h)
        h = torch.where(t["done"][step, idx][:, None, None], torch.zeros_like(new_h), new_h)
    ref = torch.stack(outs)
    assert torch.equal(ref.detach(), hseq.detach().float())
    (ref * g).sum().backward()
    got = (wh, bhn, iall)[k].grad.float()
    err, top = float((got - ref_in[k].grad).abs().max()), float(ref_in[k].grad.abs().max())
    assert err <= 3e-2 * top, (err, top)
    if k == 0:  # Wh enters the scan in bf16: its gradient is bf16-exact
        assert torch.equal(wh.grad, wh.grad.to(torch.bfloat16).float())


@pytest.fixture(scope="module")
def fused_pair():
    """One band's gradients: the port's ``rnn_fused_grads`` (plain K11 and
    K13), JAX's ``rnn_fused_grads(interpret=True)``, and autograd of the
    port's ``rnn_ppo_loss_native`` (plain K9 and K10)."""
    rng = np.random.default_rng(1)
    model = FlaxRecurrent(n_actions=A, hidden=HG, embed=E)
    params = model.init(jax.random.key(0), model.initialize_carry((1, N)), jnp.zeros((1, N, L)))
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(np.float32), params)
    obs = bf16_values(rng.integers(0, 3, (T_LEN, B, N, L)) * 0.5)
    done = rng.random((T_LEN, B)) < 0.2
    action = rng.integers(0, A, (T_LEN, B, N)).astype(np.int32)
    logp = (rng.standard_normal((T_LEN, B, N)) * 0.1 - 1.6).astype(np.float32)
    value, adv, target = (rng.standard_normal((T_LEN, B, N)).astype(np.float32)
                          for _ in range(3))
    h0 = bf16_values(rng.standard_normal((B, N, HG)) * 0.3)
    jbatch = (
        jnp.asarray(band(obs, 1).reshape(T_LEN, RB, LANE, N, L).transpose(0, 3, 1, 2, 4),
                    jnp.bfloat16),
        jnp.asarray(band(done, 1).reshape(T_LEN, 1, RB, LANE).astype(np.int32)),
        *(jnp.asarray(small_to_jax(x)) for x in (action, logp, value, adv, target)),
        jnp.asarray(h0_to_jax(h0), jnp.bfloat16),
    )
    jcfg = JaxConfig(minibatches=1)
    jgrads, jmets = jit_bf16_exact(
        lambda p, b: jax_rnn.rnn_fused_grads(jcfg, model, p, b, interpret=True), params, jbatch)
    dims = nets.GruDims(L, E, HG, A)
    flat = gru_params_from_flax(params)
    dataset = (torch.from_numpy(obs).to(torch.bfloat16), torch.from_numpy(done),
               *(torch.from_numpy(x) for x in (action, logp, value, adv, target)),
               torch.from_numpy(h0).to(torch.bfloat16))
    fwd = build_fused_gru_seq_fwd(dims)
    loss = build_fused_gru_loss_bwd(dims, CFG.clip_eps, CFG.vf_coef, CFG.ent_coef)
    grads, metrics = ippo_rnn.rnn_fused_grads(CFG, dims, flat, dataset, (START, N_ENV), fwd,
                                              loss)
    ref, ref_mets = loss_grads(
        lambda p: ippo_rnn.rnn_ppo_loss_native(CFG, dims, p, dataset, (START, N_ENV),
                                               build_fused_gru_obs_fwd(dims),
                                               build_fused_gru_obs_bwd(dims)), flat)
    return dict(dims=dims, grads=grads, metrics=metrics, jgrads=gru_params_from_flax(
        jax.tree.map(np.asarray, jgrads)), jmets=jmets, ref=ref, ref_mets=ref_mets,
        launches=fwd.launches + loss.launches)


BLOCKS = ("dWe", "dbe", "dWi", "dbi", "dWh", "dbhn", "dWhead", "dbhead")


@pytest.mark.parametrize("k", range(8), ids=BLOCKS)
def test_rnn_fused_grads_match_jax(fused_pair, k):
    dims = fused_pair["dims"]
    got, want = dims.split(fused_pair["grads"])[k], dims.split(fused_pair["jgrads"])[k]
    assert_block_close(got.numpy(), want.numpy(), 1e-2, BLOCKS[k])


@pytest.mark.parametrize("k", range(8), ids=BLOCKS)
def test_rnn_fused_grads_match_autograd_of_the_loss(fused_pair, k):
    dims = fused_pair["dims"]
    got, want = dims.split(fused_pair["grads"])[k], dims.split(fused_pair["ref"])[k]
    assert_block_close(got.numpy(), want.numpy(), 0.06, BLOCKS[k])


def test_rnn_fused_grads_metrics(fused_pair):
    assert fused_pair["launches"] == 0  # CPU: the plain versions
    for k in METRICS:
        got = float(fused_pair["metrics"][k])
        np.testing.assert_allclose(got, float(fused_pair["jmets"][k]), rtol=1e-3, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(got, float(fused_pair["ref_mets"][k]), rtol=3e-2, atol=3e-3,
                                   err_msg=k)


def test_wrappers_check_their_arguments(port_side):
    t, fwd, bwd, loss = (port_side[k] for k in ("t", "fwd", "bwd", "loss"))
    seq = (t["wh"], t["bhn"], t["iall"], t["done"], t["h0"])
    with pytest.raises(ValueError, match="iall must be bf16"):
        fwd(*seq[:2], t["iall"].float(), *seq[3:], START, N_ENV)
    with pytest.raises(ValueError, match="iall must be bf16"):
        fwd(*seq, START, N_ENV - 128)
    with pytest.raises(ValueError, match="band"):
        fwd(*seq, B, N_ENV)
    with pytest.raises(ValueError, match="h0 must be bf16"):
        fwd(*seq[:4], t["h0"].float(), START, N_ENV)
    with pytest.raises(ValueError, match="dhseq must be bf16"):
        bwd(*seq, port_side["hseq"], t["dh"].float(), START, N_ENV)
    with pytest.raises(ValueError, match="action must be"):
        loss(t["wh"], t["bhn"], t["whead"], t["bhead"], *seq[2:], port_side["hseq"],
             t["action"].long(), t["logp"], t["value"], t["adv"], t["target"], t["stats"],
             START, N_ENV)
    with pytest.raises(ValueError, match="no message head"):
        build_fused_gru_loss_bwd(nets.GruDims(L, E, HG, A, 2), 0.2, 0.5, 0.01)
    with pytest.raises(ValueError, match="no message bits"):
        ippo_rnn.rnn_fused_grads(CFG, nets.GruDims(L, E, HG, A, 2), None, None, (0, 1), fwd,
                                 loss)
