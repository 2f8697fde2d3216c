"""The port's recurrent actor-critic against the JAX package's, on the CPU.

One GRU cell has three roundings in the JAX package, and the port names each:
the fused collector's (``pallas_rollout._gru_forward``), the sequence
kernels' (``pallas_gru.build_gru_obs_fwd`` with the replay's bf16 head
weights) and flax's own ``model.apply``.  The same numpy-seeded parameters and
inputs go through both sides.

Tolerances: a product summed in another order moves a float32 sum by an ulp,
which the next bf16 rounding hides unless the sum sits on a rounding
boundary; then one entry moves by one bf16 step (at most 2**-7 = 7.8e-3 for
|h| <= 1).  So hidden states must agree to the bit on all but 0.5% of the
entries and within one bf16 step everywhere; float32 heads on such a hidden
within 2e-2 (the bound of the JAX package's own collector tests).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rware_tpu.models.networks import RecurrentActorCritic as FlaxRecurrent
from rware_tpu_torch import convert
from rware_tpu_torch.models import networks as nets
from tests.torch_ref import jit_bf16_exact

torch.set_num_threads(1)

BF16_STEP = 2.0 ** -7
L, E, HG, A = 31, 12, 16, 5


def flax_params(seed, obs_len=L, embed=E, hidden=HG, bias_scale=0.3):
    """A flax RecurrentActorCritic params pytree with numpy-seeded weights
    and nonzero biases (zero biases hide where a bias is rounded)."""
    rng = np.random.default_rng(seed)

    def dense(i, o, bias=True):
        d = {"kernel": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)}
        if bias:
            d["bias"] = (bias_scale * rng.standard_normal(o)).astype(np.float32)
        return d

    gru = {k: dense(embed, hidden) for k in ("ir", "iz", "in")}
    gru.update(hr=dense(hidden, hidden, False), hz=dense(hidden, hidden, False),
               hn=dense(hidden, hidden))
    return {"params": {"embed": dense(obs_len, embed), "gru": gru,
                       "policy": dense(hidden, A), "value": dense(hidden, 1)}}


def cell_inputs(seed, m, obs_len=L, hidden=HG):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 3, (m, obs_len)).astype(np.float32) * 0.5
    h = np.array(jnp.asarray(rng.uniform(-1, 1, (m, hidden)), jnp.bfloat16).astype(jnp.float32))
    return obs, h


def hidden_close(got, want, frac=5e-3):
    """Equal to the bit but for ``frac`` of the entries, those within one bf16 step."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    assert diff.max() <= BF16_STEP + 1e-6, diff.max()
    assert (diff > 0).mean() <= frac, (diff > 0).mean()


def port_arrays(params):
    dims = nets.GruDims(L, E, HG, A)
    return dims, dims.split(convert.gru_params_from_flax(params))


def test_converters_round_trip():
    params = flax_params(0)
    dims, arrays = port_arrays(params)
    flat = nets.pack_arrays(arrays)
    assert flat.numel() == dims.n_params == (L + 1) * E + (E + 1) * 3 * HG + HG * 3 * HG + HG \
        + (HG + 1) * (A + 1)
    back = convert.gru_params_to_flax(flat, dims)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    model = convert.recurrent_from_flax(params)
    assert nets.GruDims.of(model) == dims
    for a, b in zip(nets.gru_to_arrays(model), arrays):
        assert torch.equal(a, b)
    model2 = nets.arrays_to_gru(arrays)
    for a, b in zip(model.state_dict().values(), model2.state_dict().values()):
        assert torch.equal(a, b)


def test_init_is_flax_default_distribution():
    model = nets.init_recurrent_actor_critic(71, 5, 128, 128, seed=3)
    again = nets.init_recurrent_actor_critic(71, 5, 128, 128, seed=3)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    for k in nets.GRU_HIDDEN_GATES:
        w = model.gru[k].weight.double()
        assert torch.allclose(w @ w.t(), torch.eye(128, dtype=torch.float64), atol=1e-5), k
    for k in nets.GRU_INPUT_GATES:
        std = float(model.gru[k].weight.detach().std())
        assert abs(std - 1 / np.sqrt(128)) < 0.1 / np.sqrt(128), (k, std)
        assert float(model.gru[k].bias.abs().max()) == 0.0
    assert model.gru["hr"].bias is None and model.gru["hz"].bias is None
    assert model.initialize_carry((4, 2)).shape == (4, 2, 128)
    assert model.initialize_carry((4, 2)).dtype == torch.bfloat16


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_step_matches_flax_model_apply(seed):
    """``gru_apply_step`` against flax ``model.apply`` over four chained steps."""
    params = flax_params(seed)
    _, arrays = port_arrays(params)
    model = FlaxRecurrent(n_actions=A, hidden=HG, embed=E)
    obs, h = cell_inputs(seed, 256)
    jh, th = jnp.asarray(h, jnp.bfloat16), torch.from_numpy(h).to(torch.bfloat16)
    for step in range(4):
        o = np.roll(obs, step, axis=0)
        jh, (jl, jv) = jit_bf16_exact(lambda c, x: model.apply(params, c, x), jh, jnp.asarray(o))
        th, tl, tv = nets.gru_apply_step(arrays, th, torch.from_numpy(o))
        hidden_close(th.float().numpy(), np.asarray(jh.astype(jnp.float32)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-2)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-2)
        th = torch.from_numpy(np.array(jh.astype(jnp.float32))).to(torch.bfloat16)
    torch_model = convert.recurrent_from_flax(params)
    carry, (logits, value) = torch_model(th.reshape(128, 2, HG),
                                         torch.from_numpy(obs).reshape(128, 2, L))
    assert carry.shape == (128, 2, HG) and logits.shape == (128, 2, A) and value.shape == (128, 2)


def test_collect_step_matches_the_collector_cell():
    """``gru_collect_step`` against ``pallas_rollout._gru_forward`` on one
    env tile (N=1, 8 x 128 columns)."""
    from rware_tpu.ops.pallas_rollout import LANE, SUB, _gru_forward

    params = flax_params(2)
    _, arrays = port_arrays(params)
    p, g = params["params"], params["params"]["gru"]
    bf, f32 = jnp.bfloat16, jnp.float32
    jparams = (
        jnp.asarray(p["embed"]["kernel"], bf), jnp.asarray(p["embed"]["bias"], f32)[None],
        jnp.asarray(g["ir"]["kernel"], bf), jnp.asarray(g["ir"]["bias"], f32)[None],
        jnp.asarray(g["iz"]["kernel"], bf), jnp.asarray(g["iz"]["bias"], f32)[None],
        jnp.asarray(g["in"]["kernel"], bf), jnp.asarray(g["in"]["bias"], f32)[None],
        jnp.asarray(g["hr"]["kernel"], bf), jnp.asarray(g["hz"]["kernel"], bf),
        jnp.asarray(g["hn"]["kernel"], bf), jnp.asarray(g["hn"]["bias"], f32)[None],
        jnp.asarray(p["policy"]["kernel"], f32), jnp.asarray(p["policy"]["bias"], f32)[None],
        jnp.asarray(p["value"]["kernel"], f32), jnp.asarray(p["value"]["bias"], f32)[None],
    )
    m = SUB * LANE
    obs, h = cell_inputs(2, m)
    feats = jnp.asarray(obs.T.reshape(L, 1, SUB, LANE), bf)
    jl, jv, _, jh = jit_bf16_exact(lambda f, hh: _gru_forward(jparams, f, hh), feats,
                                   jnp.asarray(h.T, bf))
    tl, tv, th = nets.gru_collect_step(arrays, torch.from_numpy(h),
                                       torch.from_numpy(obs).to(torch.bfloat16))
    hidden_close(th.numpy(), np.asarray(jh.astype(f32)).T)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl).T, atol=2e-2)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv)[0], atol=2e-2)


def test_replay_step_matches_the_sequence_kernel():
    """``gru_replay_step`` chained over T=2 steps against
    ``build_gru_obs_fwd`` in interpret mode, and the replay's bf16 heads."""
    from rware_tpu.ops.pallas_gru import build_gru_obs_fwd

    params = flax_params(3)
    _, arrays = port_arrays(params)
    t_len, n, rb = 2, 2, 1
    rng = np.random.default_rng(3)
    obs = (rng.integers(0, 3, (t_len, n, rb, 128, L)) * 0.5).astype(np.float32)
    h0 = np.array(jnp.asarray(rng.uniform(-1, 1, (n, rb, 128, HG)), jnp.bfloat16)
                  .astype(jnp.float32))
    done = np.zeros((t_len, 1, rb, 128), np.float32)
    p, g = params["params"], params["params"]["gru"]
    wi = np.concatenate([g[k]["kernel"] for k in ("ir", "iz", "in")], 1)
    bi = np.concatenate([g[k]["bias"] for k in ("ir", "iz", "in")])
    wh = np.concatenate([g[k]["kernel"] for k in ("hr", "hz", "hn")], 1)
    fwd = build_gru_obs_fwd(t_len, n, rb, HG, E, L, interpret=True)
    jhseq = jit_bf16_exact(
        fwd, jnp.asarray(p["embed"]["kernel"]), jnp.asarray(p["embed"]["bias"]),
        jnp.asarray(wi), jnp.asarray(bi), jnp.asarray(wh, jnp.bfloat16),
        jnp.asarray(g["hn"]["bias"]), jnp.asarray(obs, jnp.bfloat16), jnp.asarray(done),
        jnp.asarray(h0, jnp.bfloat16))
    h = torch.from_numpy(h0)
    for t in range(t_len):
        h = nets.gru_replay_step(arrays[:6], h, torch.from_numpy(obs[t]))
        hidden_close(h.numpy(), np.asarray(jhseq[t].astype(jnp.float32)))
    # the replay's heads: bf16-rounded weights on the bf16 hidden, f32 sums
    whead = jnp.concatenate([jnp.asarray(p["policy"]["kernel"]),
                             jnp.asarray(p["value"]["kernel"])], 1).astype(jnp.bfloat16)
    jheads = jax.lax.dot_general(jhseq, whead, (((4,), (0,)), ((), ())),
                                 preferred_element_type=jnp.float32)
    hs = torch.from_numpy(np.asarray(jhseq.astype(jnp.float32)))
    logits, value = nets.gru_replay_heads(arrays[6], arrays[7], hs)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jheads[..., :A]) + p["policy"]["bias"],
                               atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(jheads[..., A]) + p["value"]["bias"][0],
                               atol=1e-5)


def test_the_three_roundings_differ():
    """With nonzero biases the three cells round differently: a port that
    used one for another would not match the JAX package."""
    params = flax_params(4, bias_scale=1.0)
    _, arrays = port_arrays(params)
    obs, h = cell_inputs(4, 2048)
    o, hh = torch.from_numpy(obs), torch.from_numpy(h)
    collect = nets.gru_collect_step(arrays, hh, o.to(torch.bfloat16))[2]
    replay = nets.gru_replay_step(arrays[:6], hh, o)
    apply = nets.gru_apply_step(arrays, hh, o)[0].float()
    assert not torch.equal(collect, replay)
    assert not torch.equal(collect, apply)
    assert not torch.equal(replay, apply)
    for x in (replay, apply):
        assert float((x - collect).abs().max()) <= 4 * BF16_STEP


def test_ordered_matmul_and_sigmoid():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((64, 20)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((20, 7)).astype(np.float32))
    np.testing.assert_allclose(nets.ordered_matmul(x, w).numpy(), (x @ w).numpy(), atol=1e-5)
    assert torch.equal(nets.ordered_matmul(x, w), nets.ordered_linear(x, w.t(), torch.zeros(7)))
    v = torch.linspace(-30, 30, 2001)
    np.testing.assert_allclose(nets.sigmoid_f32(v).numpy(), torch.sigmoid(v).numpy(), atol=1e-7)
    g = torch.ones(3, requires_grad=True)
    nets.bf16_param(g * 1.00390625).sum().backward()
    assert torch.equal(g.grad, torch.full((3,), 1.00390625))
