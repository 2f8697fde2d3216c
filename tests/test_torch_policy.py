"""The port's ActorCritic against flax ``ActorCritic.apply`` with converted
parameters, the converters' round trips, and the sampling law."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rware_tpu.models import ActorCritic as FlaxActorCritic
from rware_tpu_torch.convert import actor_critic_from_flax, actor_critic_to_flax
from rware_tpu_torch.models import ActorCritic, sample_action
from rware_tpu_torch.models.networks import ordered_linear
from tests.torch_ref import jax_states, make_pair

torch.set_num_threads(1)

# bf16 hidden layers round at other places in flax (bf16 dot output, bf16
# bias add) than in the Pallas recipe the port follows: the bound of
# tests/test_pallas_collect.py.
ATOL = 2e-2


def _flax_params(obs_dim, hidden, seed=1):
    model = FlaxActorCritic(n_actions=5, hidden=hidden)
    return model, model.init(jax.random.key(seed), jnp.zeros((1, 2, obs_dim)))


def _env_obs(env_id, n_envs=256):
    jenv, _ = make_pair(env_id)
    states = jax_states(jenv, n_envs, seed=2)
    return np.array(jax.vmap(jenv._obs_fn)(states))  # a writable copy


@pytest.mark.parametrize(
    "env_id,hidden",
    [("rware-tiny-2ag-v2", (128, 128)), ("rware-small-4ag-v2", (64, 32)),
     ("rware-2s-tiny-2ag-v2", (128, 128))],
)
def test_actor_critic_matches_flax(env_id, hidden):
    obs = _env_obs(env_id)
    model, params = _flax_params(obs.shape[-1], hidden)
    logits_ref, value_ref = model.apply(params, jnp.asarray(obs))
    logits_ref, value_ref = np.asarray(logits_ref), np.asarray(value_ref)
    policy = actor_critic_from_flax(jax.tree.map(np.asarray, params))
    assert policy.hidden == hidden and policy.obs_dim == obs.shape[-1]
    with torch.no_grad():
        logits, value = policy(torch.from_numpy(obs))
    assert logits.dtype == torch.float32 and logits.shape == logits_ref.shape
    np.testing.assert_allclose(value.numpy(), value_ref, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), logits_ref, atol=ATOL)
    # argmax equal except where flax's top two logits are closer than ATOL
    top2 = np.sort(logits_ref, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > ATOL
    np.testing.assert_array_equal(
        logits.argmax(-1).numpy()[clear], logits_ref.argmax(-1)[clear]
    )


def test_flax_params_round_trip():
    _, params = _flax_params(71, (128, 128))
    params = jax.tree.map(np.asarray, params)
    back = actor_critic_to_flax(actor_critic_from_flax(params))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b) == 8
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_module_round_trip_keeps_forward():
    torch.manual_seed(0)
    policy = ActorCritic(obs_dim=71)
    again = actor_critic_from_flax(actor_critic_to_flax(policy))
    x = torch.rand(32, 2, 71)
    with torch.no_grad():
        for a, b in zip(policy(x), again(x)):
            assert torch.equal(a, b)


def test_ordered_linear_matches_matmul():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 40, generator=g)
    w = torch.randn(24, 40, generator=g)
    b = torch.randn(24, generator=g)
    # same products, another summation order: f32 rounding only
    torch.testing.assert_close(ordered_linear(x, w, b), x @ w.t() + b, rtol=1e-5, atol=1e-5)


def test_sample_action_argmax_and_logp():
    logits = torch.tensor([[0.5, 2.0, -1.0, 2.0, 0.0], [3.0, 1.0, 0.0, 0.0, 0.0]])
    action, logp = sample_action(logits)
    assert action.tolist() == [1, 0]  # ties go to the lowest action
    want = torch.log_softmax(logits, -1).gather(1, action.long()[:, None])[:, 0]
    torch.testing.assert_close(logp, want)


def test_gumbel_sampling_law():
    """Gumbel-argmax over 23-bit uniforms samples softmax(logits)."""
    from rware_tpu_torch.ops import philox

    logits = torch.tensor([1.0, 0.0, -1.0, 0.5, 2.0])
    n = 40000
    bits = philox.uniform_bits(123, torch.arange(n), 0, philox.ACTION, 5)
    action, logp = sample_action(logits.expand(n, 5), philox.gumbel_uniform(bits))
    freq = torch.bincount(action.long(), minlength=5).double() / n
    p = torch.softmax(logits.double(), 0)
    sigma = (p * (1 - p) / n).sqrt()
    assert ((freq - p).abs() < 5 * sigma).all(), (freq, p)
    torch.testing.assert_close(logp, torch.log_softmax(logits, 0)[action.long()])
