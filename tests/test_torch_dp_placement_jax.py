"""The port's data-parallel plain IPPO update against the JAX package's
``ppo_update_epochs`` placed on a device mesh, on the CPU (that placement
keeps JAX's single-device meaning: ``tests/test_torch_dp_placement_semantics.py``):
one global dataset made with numpy from a seed
(tiny-2ag, B=64, T=8, hidden (128, 128)), JAX's initial parameters and
Adam state (``convert.params_from_flax``, ``adam_state_from_optax``).  JAX's
``ppo_update_epochs`` (``ippo.py:169``) runs on the dataset placed over two
devices (split on the env axis) with its key; the port's
``PlainTrainStep.update`` runs on two emulated ranks
(``testing.emulate_mesh``), each holding its half of the envs, with JAX's E
permutations (``shuffle``) or offsets (``block``) handed in; E=2, M=2.  The
test also replays JAX's update one minibatch at a time with JAX's own
``ppo_loss`` and optimizer (checked bit for bit against
``ppo_update_epochs``) to read JAX's Adam state after each step.

* The first pass (before Adam): its gradients within 5% of each block's
  largest magnitude and its metrics within rtol 1e-2, atol 1e-6 of JAX's on
  the same rows, as ``tests/test_torch_ippo.py`` holds the plain loss's
  gradient to JAX's.
* The whole update: the metrics' means within rtol 2e-2, atol 2e-3
  (``tests/test_torch_ippo.py``'s); the parameters within 0.05 * lr * P (P
  = E * M), rtol 1e-3, for at least 99.5% of them, and each of the rest one
  whose gradient was near zero: JAX's bias-corrected Adam mean |mu / (1 -
  0.9^k)| at most ``NEAR_ZERO_GRAD`` = 5e-5 after some step k <= P (the rule
  of ``tests/test_torch_seac_a2c_train.py``, whose bound is 3e-5).  Adam
  moves such a parameter by ``lr * g / (|g| + 1e-5)``, so a rounding that
  flips a near-zero ``g`` moves it by up to lr.  The two losses' first-pass
  gradients differ by up to 5e-5 in the weight blocks and 1.6e-4 in the
  bias blocks (their bf16 roundings), and the
  parameters outside 0.05 * lr * P (0.24% of them) read at most 3.7e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import rware_tpu_torch
from rware_tpu.models import ippo as jax_ippo
from rware_tpu.parallel import make_mesh, replicate
from rware_tpu_torch.convert import adam_state_from_optax, params_from_flax
from rware_tpu_torch.models import ippo
from rware_tpu_torch.models.networks import BlockDims
from rware_tpu_torch.testing import emulate_mesh
from tests.torch_ref import compile_bf16_exact, jit_bf16_exact, make_pair

torch.set_num_threads(1)

ENV = "rware-tiny-2ag-v2"
B, T_LEN, EPOCHS, MINIBATCHES = 64, 8, 2, 2
GRAD_TOL = 0.05  # of each leaf's largest magnitude, as tests/test_torch_ippo.py's
PARAM_SHARE = 0.995  # of the parameters within 0.05 * lr * P, rtol 1e-3
NEAR_ZERO_GRAD = 5e-5  # JAX's bias-corrected Adam mean that counts as a near-zero gradient
ADAM_B1 = 0.9
METRIC_TOL = dict(rtol=2e-2, atol=2e-3)  # the update's, as tests/test_torch_ippo.py's


def _mesh():
    return make_mesh(jax.devices()[:2])


def dataset(seed=0):
    """A global dataset (T, B, ...) made with numpy, JAX's runner at init,
    and its model: behaviour log-probs near the model's own, so the ratios
    sit around 1."""
    jenv, _ = make_pair(ENV)
    jcfg = jax_ippo.IPPOConfig(n_envs=B, rollout_len=T_LEN, epochs=EPOCHS,
                               minibatches=MINIBATCHES)
    jrunner, model, tx = jax_ippo.init_runner(jenv, jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    n, l_obs = jenv.n_agents, jenv.config.policy_obs_length
    obs = rng.integers(0, 3, (T_LEN, B, n, l_obs)).astype(np.float32) * 0.5
    action = rng.integers(0, jenv.n_actions, (T_LEN, B, n)).astype(np.int32)
    logits, value = model.apply(jrunner.params, jnp.asarray(obs))
    logp = np.take_along_axis(np.asarray(jax.nn.log_softmax(logits)), action[..., None], -1)[..., 0]
    data = {"obs": obs, "action": action,
            "logp": (logp + 0.05 * rng.standard_normal(logp.shape)).astype(np.float32),
            "value": (np.asarray(value) + 0.1 * rng.standard_normal(logp.shape))
            .astype(np.float32),
            "adv": rng.standard_normal((T_LEN, B, n)).astype(np.float32)}
    data["target"] = (data["adv"] + data["value"]).astype(np.float32)
    return jenv, jcfg, jrunner, model, tx, data


KEYS = ("obs", "action", "logp", "value", "adv", "target")


def jax_step_means(model, jcfg, tx, params, opt_state, flat, minibatches):
    """JAX's update replayed one minibatch at a time (``ippo.py:177-182``):
    the final (params, opt_state) and each step's bias-corrected |Adam mean|."""

    def sgd_step(params, opt_state, batch):
        grads = jax.grad(lambda q: jax_ippo.ppo_loss(model, jcfg, q, batch)[0])(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    step = None
    means = []
    for k, idx in enumerate(minibatches, 1):
        batch = tuple(x[idx] for x in flat)
        step = step or compile_bf16_exact(sgd_step, params, opt_state, batch)
        params, opt_state = step(params, opt_state, batch)
        mu = params_from_flax(jax.tree.map(np.asarray, opt_state[1][0].mu)).numpy()
        means.append(np.abs(mu) / (1 - ADAM_B1 ** k))
    return params, opt_state, np.min(means, axis=0)


@pytest.mark.parametrize("mode", ["shuffle", "block"])
def test_two_ranks_match_jax_placed_update(mode):
    jenv, jcfg, jrunner, model, tx, data = dataset()
    jcfg = dataclasses.replace(jcfg, minibatch_mode=mode)
    key = jax.random.key(7)
    n_data, mb = T_LEN * B, T_LEN * B // MINIBATCHES
    keys = jax.random.split(key, EPOCHS)
    if mode == "shuffle":
        draws = np.stack([np.asarray(jax.random.permutation(k, n_data)) for k in keys])
        rows = [r for perm in draws for r in perm[:mb * MINIBATCHES].reshape(MINIBATCHES, mb)]
    else:
        draws = np.array([int(jax.random.randint(k, (), 0, n_data)) for k in keys])
        # roll(x, off)[i * mb:(i + 1) * mb]
        rows = [(np.arange(mb) + i * mb - off) % n_data for off in draws
                for i in range(MINIBATCHES)]

    def flat(arrays):
        return tuple(x.reshape((-1,) + x.shape[2:]) for x in arrays)

    def update(params, opt_state, arrays, key):
        return jax_ippo.ppo_update_epochs(model, jcfg, tx, params, opt_state, flat(arrays), key)

    def first_pass(params, arrays):
        batch = tuple(x[rows[0]] for x in flat(arrays))
        return jax.value_and_grad(lambda q: jax_ippo.ppo_loss(model, jcfg, q, batch),
                                  has_aux=True)(params)

    mesh = _mesh()
    split = NamedSharding(mesh, P(None, "env"))
    arrays = tuple(jax.device_put(jnp.asarray(data[k]), split) for k in KEYS)
    jparams0, jopt0 = replicate(jrunner.params, mesh), replicate(jrunner.opt_state, mesh)
    (jparams, jopt), jmetrics = jit_bf16_exact(update, jparams0, jopt0, arrays, key)
    (_, jfirst_metrics), jgrads = jit_bf16_exact(first_pass, jparams0, arrays)
    want = params_from_flax(jax.tree.map(np.asarray, jparams))
    want_grads = params_from_flax(jax.tree.map(np.asarray, jgrads))
    replayed, _, least_mean = jax_step_means(
        model, jcfg, tx, jrunner.params, jrunner.opt_state,
        flat(tuple(jnp.asarray(data[k]) for k in KEYS)), rows)
    assert torch.equal(params_from_flax(jax.tree.map(np.asarray, replayed)), want)

    env = rware_tpu_torch.make(ENV, device="cpu")
    cfg = ippo.IPPOConfig(n_envs=B, rollout_len=T_LEN, epochs=EPOCHS, minibatches=MINIBATCHES,
                          minibatch_mode=mode)
    params = params_from_flax(jax.tree.map(np.asarray, jrunner.params))
    opt_state = adam_state_from_optax(jax.tree.map(np.asarray, jrunner.opt_state))
    dims = BlockDims(jenv.config.policy_obs_length, 128, 128, jenv.n_actions)

    def rank(mesh):
        rows = slice(mesh.rank * B // mesh.world, (mesh.rank + 1) * B // mesh.world)
        part = {k: torch.from_numpy(np.ascontiguousarray(v[:, rows])) for k, v in data.items()}
        traj = {k: part[k] for k in ("obs", "action", "logp", "value")}
        traj.update(reward=torch.zeros_like(part["value"]),
                    done=torch.zeros(part["value"].shape[:2], dtype=torch.bool))
        runner = ippo.RunnerState(params=params.clone(), opt_state=opt_state, env_states=None,
                                  obs=None, generator=torch.Generator(), update_idx=0, seed=0)
        passes, reduce = [], mesh.all_reduce_sum

        def record(tree):  # each pass's gradients and metrics, summed over the ranks
            passes.append(reduce(tree))
            return passes[-1]

        mesh.all_reduce_sum = record
        step = ippo.build_train_step(env, dims, cfg, mesh)
        return step.update(runner, traj, part["adv"], part["target"], torch.as_tensor(draws)), \
            passes[0]

    ranks = emulate_mesh(rank, 2, timeout=120)
    p = EPOCHS * MINIBATCHES
    for ((got, got_opt), metrics, _), (grads, first_metrics) in ranks:
        for g, w in zip(dims.split(grads), dims.split(want_grads)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_TOL * float(w.abs().max()))
        for k, v in first_metrics.items():
            np.testing.assert_allclose(float(v), float(jfirst_metrics[k]), rtol=1e-2, atol=1e-6,
                                       err_msg=k)
        diff = np.abs(got.numpy() - want.numpy())
        outside = diff > 0.05 * cfg.lr * p + 1e-3 * np.abs(want.numpy())
        print(f"plain IPPO {mode}: max |port - JAX| {diff.max() / cfg.lr:.4g} lr, "
              f"{1 - outside.mean():.6f} of the parameters within 0.05 lr P, the rest's least "
              f"Adam mean {least_mean[outside].max() if outside.any() else 0:.3g}")
        assert 1 - outside.mean() >= PARAM_SHARE, outside.mean()
        assert (least_mean[outside] <= NEAR_ZERO_GRAD).all(), least_mean[outside].max()
        assert got_opt.count == int(jopt[1][0].count) == p
        for k, v in metrics.items():
            np.testing.assert_allclose(float(v), float(np.mean(jmetrics[k])), **METRIC_TOL,
                                       err_msg=k)
    assert torch.equal(ranks[0][0][0][0], ranks[1][0][0][0])
