"""The port's plain recurrent IPPO update (``RnnPlainTrainStep.update``)
against the JAX package's ``ippo_rnn.build_rnn_train_step`` placed on a
device mesh as ``train.py:291-303`` places it (env states, observations and
carry split over ``jax.devices()[:2]``), on the CPU; one rank and two ranks
of the in-process emulation (``testing.emulate_mesh``).

JAX's step runs once, collect and update, from a runner with biases moved
off zero and a random bf16 carry, on tiny-2ag with episodes of 6 steps (so
the replay zeroes the carry inside the rollout), B=64, T=8, E=2, M=2,
embed and GRU 32.  The test replays JAX's collect with the same keys
(checked bit for bit against the step's own env states, observations and
carry), takes GAE by the port's ``compute_gae`` on JAX's values, and hands
the port's update each rank's envs of that trajectory, its rows of the
carry and JAX's E env permutations (``ippo_rnn.py:198-220``).  It also
replays JAX's update one minibatch at a time, unplaced (its loss,
``ippo_rnn.py:120-178``, and its optimizer; checked against the placed
step's parameters within 0.05 * lr, the gap of placing the step:
``tests/test_torch_dp_placement_semantics_rnn.py``) to read JAX's Adam
state after each step.

Tolerances are those of ``tests/test_torch_train.py::test_update_matches_jax``
but two: the metrics within rtol 1e-2 and atol 1e-5, not 1e-6 (``pg_loss``
is a mean of normalised advantages times ratios near 1, which cancels to
2.6e-4 here; the two roundings move it by 6.8e-6); the parameters within 0.05 * lr *
P (P = E * M), rtol 1e-3, for at least 99.5% of them, and each of the rest
one whose gradient was near zero: JAX's bias-corrected Adam mean |mu / (1 -
0.9^k)| at most ``NEAR_ZERO_GRAD`` = 5e-5 after some step k <= P (as
``tests/test_torch_dp_placement_jax.py``).  The port replays in the rounding
of JAX's sequence kernels and JAX's plain step in flax's, so a gradient that
is near zero can flip sign, and Adam's step turns that into a move of up to
lr.  The reward and episode sums are JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rware_tpu
from rware_tpu.models import IPPOConfig as JaxConfig
from rware_tpu.models import ippo_rnn as jax_rnn
from rware_tpu.models.ippo import policy_obs_fn
from rware_tpu.models.networks import RecurrentActorCritic as FlaxRecurrent
from rware_tpu.models.networks import sample_action
from rware_tpu.parallel import make_mesh, replicate, shard_env_batch
from rware_tpu.parallel.rollout import autoreset_select
from rware_tpu_torch.convert import adam_state_from_optax, gru_params_from_flax
from rware_tpu_torch.models import ippo, ippo_rnn
from rware_tpu_torch.models.networks import GruDims
from rware_tpu_torch.testing import emulate_mesh
from tests.torch_ref import compile_bf16_exact, jit_bf16_exact, make_pair

torch.set_num_threads(1)

B, T_LEN, EPOCHS, MINIBATCHES, EMBED, HG, MAX_STEPS = 64, 8, 2, 2, 32, 32, 6
PARAM_SHARE = 0.995  # of the parameters within 0.05 * lr * P, rtol 1e-3
NEAR_ZERO_GRAD = 5e-5  # JAX's bias-corrected Adam mean that counts as a near-zero gradient
ADAM_B1 = 0.9
REPLAY_TOL = 0.05  # times lr: the replay (unplaced) against JAX's placed step
METRIC_TOL = dict(rtol=1e-2, atol=1e-5)


def collect(jenv, model, runner):
    """JAX's collect of ``build_rnn_train_step`` (``ippo_rnn.py:94-118``)
    with the step's keys: (trajectory, last value, env states, obs, carry)."""
    step_fn, obs_fn = jax.vmap(jenv._step_fn), jax.vmap(policy_obs_fn(jenv))

    def body(c, key):
        params, states, obs, carry = c
        new_carry, (logits, value) = model.apply(params, carry, obs)
        action, logp = sample_action(jax.random.split(key)[0], logits)
        res = step_fn(states, action)
        nxt = jax.vmap(lambda s, d: autoreset_select(jenv._reset_fn, s, d))(res.state, res.done)
        next_carry = jnp.where(res.done[:, None, None], jnp.zeros_like(new_carry), new_carry)
        return (params, nxt, obs_fn(nxt), next_carry), \
            dict(obs=obs, action=action, logp=logp, value=value, reward=res.rewards,
                 done=res.done)

    k_roll = jax.random.split(runner.key, 3)[1]
    (params, states, obs, carry), traj = jax.lax.scan(
        body, (runner.params, runner.env_states, runner.obs, runner.carry),
        jax.random.split(k_roll, T_LEN))
    _, (_, last_value) = model.apply(params, carry, obs)
    return traj, last_value, states, obs, carry


def gae(jcfg, traj, last_value):
    """JAX's GAE (``ippo_rnn.py:106-118``)."""
    def body(carry, t):
        g, next_v = carry
        reward, value, done = t
        nd = 1.0 - done.astype(jnp.float32)[:, None]
        delta = reward + jcfg.gamma * next_v * nd - value
        g = delta + jcfg.gamma * jcfg.gae_lambda * nd * g
        return (g, value), g

    _, adv = jax.lax.scan(body, (jnp.zeros_like(last_value), last_value),
                          (traj["reward"], traj["value"], traj["done"]), reverse=True)
    return adv, adv + traj["value"]


def loss(model, jcfg, params, batch):
    """JAX's ``loss_fn`` of ``build_rnn_train_step`` (``ippo_rnn.py:120-178``)
    without message bits on a minibatch of envs, its carry at the start."""
    traj, carry0, adv, target = batch

    def replay(carry, xs):
        obs, done = xs
        new_carry, (heads, value) = model.apply(params, carry, obs)
        return jnp.where(done[:, None, None], jnp.zeros_like(new_carry), new_carry), \
            (heads, value)

    _, (logits, value) = jax.lax.scan(replay, carry0, (traj["obs"], traj["done"]))
    logp_all = jax.nn.log_softmax(logits)
    logp = jnp.take_along_axis(logp_all, traj["action"][..., None], -1).squeeze(-1)
    ratio = jnp.exp(logp - traj["logp"])
    adv_norm = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg_loss = -jnp.minimum(ratio * adv_norm,
                           jnp.clip(ratio, 1 - jcfg.clip_eps, 1 + jcfg.clip_eps) * adv_norm).mean()
    v_clipped = traj["value"] + jnp.clip(value - traj["value"], -jcfg.clip_eps, jcfg.clip_eps)
    v_loss = 0.5 * jnp.maximum((value - target) ** 2, (v_clipped - target) ** 2).mean()
    entropy = (-(jnp.exp(logp_all) * logp_all).sum(-1)).mean()
    return pg_loss + jcfg.vf_coef * v_loss - jcfg.ent_coef * entropy


def replay_update(model, jcfg, tx, jrunner, traj, last_value, draws):
    """JAX's update replayed one minibatch at a time: the final parameters and
    each parameter's least bias-corrected |Adam mean| over the steps."""
    adv, target = jit_bf16_exact(lambda t, v: gae(jcfg, t, v), traj, last_value)

    def sgd_step(params, opt_state, idx):
        batch = jax.tree.map(lambda x: jnp.take(x, idx, axis=1), (traj, adv, target))
        batch = (batch[0], jnp.take(jrunner.carry, idx, axis=0), batch[1], batch[2])
        grads = jax.grad(lambda q: loss(model, jcfg, q, batch))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, opt_state = jrunner.params, jrunner.opt_state
    mb = B // MINIBATCHES
    idxs = [jnp.asarray(perm[:mb * MINIBATCHES].reshape(MINIBATCHES, mb)[m])
            for perm in draws for m in range(MINIBATCHES)]
    step = compile_bf16_exact(sgd_step, params, opt_state, idxs[0])
    means = []
    for k, idx in enumerate(idxs, 1):
        params, opt_state = step(params, opt_state, idx)
        mu = gru_params_from_flax(jax.tree.map(np.asarray, opt_state[1][0].mu)).numpy()
        means.append(np.abs(mu) / (1 - ADAM_B1 ** k))
    return params, np.min(means, axis=0)


def _bytes(x):
    if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key):
        x = jax.random.key_data(x)
    return np.asarray(x).tobytes()


@pytest.fixture(scope="module")
def jax_case():
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", max_steps=MAX_STEPS).config)
    jcfg = JaxConfig(n_envs=B, rollout_len=T_LEN, epochs=EPOCHS, minibatches=MINIBATCHES)
    model = FlaxRecurrent(n_actions=5, hidden=HG, embed=EMBED)
    jrunner, model, tx = jax_rnn.init_rnn_runner(jenv, jcfg, jax.random.key(4), model)
    rng = np.random.default_rng(6)
    biased = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.2 * rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "bias" else x, jrunner.params)
    carry = jnp.asarray(0.5 * rng.standard_normal((B, 2, HG)), jnp.bfloat16)
    jrunner = jrunner.replace(params=biased, opt_state=tx.init(biased), carry=carry)

    mesh = make_mesh(jax.devices()[:2])
    placed = jrunner.replace(env_states=shard_env_batch(jrunner.env_states, mesh),
                             obs=shard_env_batch(jrunner.obs, mesh),
                             carry=shard_env_batch(jrunner.carry, mesh),
                             params=replicate(jrunner.params, mesh),
                             opt_state=replicate(jrunner.opt_state, mesh))
    jnew, jmetrics = jit_bf16_exact(jax_rnn.build_rnn_train_step(jenv, model, tx, jcfg), placed)
    traj, last_value, states, obs, new_carry = jit_bf16_exact(
        lambda r: collect(jenv, model, r), jrunner)
    for a, b in zip(jax.tree.leaves((states, obs, new_carry)),
                    jax.tree.leaves((jnew.env_states, jnew.obs, jnew.carry))):
        assert _bytes(a) == _bytes(b)  # the same collect
    k_perm = jax.random.split(jrunner.key, 3)[2]
    draws = np.stack([np.asarray(jax.random.permutation(k, B))
                      for k in jax.random.split(k_perm, EPOCHS)])
    replayed, least_mean = replay_update(model, jcfg, tx, jrunner, traj, last_value, draws)
    for a, b in zip(jax.tree.leaves(replayed), jax.tree.leaves(jnew.params)):
        np.testing.assert_allclose(a, b, atol=REPLAY_TOL * jcfg.lr)  # the same update
    return dict(env=env, jrunner=jrunner, jnew=jnew, jmetrics=jmetrics, draws=draws,
                traj={k: np.asarray(v) for k, v in traj.items()},
                last_value=np.asarray(last_value), least_mean=least_mean)


@pytest.mark.parametrize("world", [1, 2])
def test_ranks_match_jax_placed_rnn_update(jax_case, world):
    c = jax_case
    env, jrunner, traj = c["env"], c["jrunner"], c["traj"]
    dims = GruDims(env.config.policy_obs_length, EMBED, HG, 5)
    cfg = ippo.IPPOConfig(n_envs=B, rollout_len=T_LEN, epochs=EPOCHS, minibatches=MINIBATCHES)
    whole = {k: torch.from_numpy(np.array(v)) for k, v in traj.items()}
    whole["obs"], whole["action"] = whole["obs"].float(), whole["action"].long()
    adv, targets = ippo.compute_gae(cfg, whole["reward"], whole["value"], whole["done"],
                                    torch.from_numpy(c["last_value"]))
    assert int(whole["done"].sum()) > 0  # the replay zeroes the carry inside the rollout
    params = gru_params_from_flax(jax.tree.map(np.asarray, jrunner.params))
    opt_state = adam_state_from_optax(jax.tree.map(np.asarray, jrunner.opt_state),
                                      from_flax=gru_params_from_flax)
    carry = torch.from_numpy(np.asarray(jrunner.carry.astype(jnp.float32))).to(torch.bfloat16)

    def rank(mesh):
        envs = mesh.env_slice(B)
        runner = ippo_rnn.RNNRunnerState(
            params=params.clone(), opt_state=opt_state, env_states=None, obs=None,
            carry=carry[envs].clone(), generator=torch.Generator(), update_idx=0, seed=0)
        step = ippo_rnn.build_rnn_train_step(env, dims, cfg, mesh)
        return step.update(runner, {k: v[:, envs] for k, v in whole.items()}, adv[:, envs],
                           targets[:, envs], torch.as_tensor(c["draws"]))

    ranks = emulate_mesh(rank, world, timeout=120)
    p = EPOCHS * MINIBATCHES
    want = gru_params_from_flax(jax.tree.map(np.asarray, c["jnew"].params)).numpy()
    adam, least_mean = c["jnew"].opt_state[1][0], c["least_mean"]
    for (got, got_opt), metrics, sums in ranks:
        diff = np.abs(got.numpy() - want)
        outside = diff > 0.05 * cfg.lr * p + 1e-3 * np.abs(want)
        print(f"plain recurrent IPPO on {world} rank(s): max |port - JAX| "
              f"{diff.max() / cfg.lr:.4g} lr, {1 - outside.mean():.6f} of the parameters within "
              f"0.05 lr P, the rest's least Adam mean "
              f"{least_mean[outside].max() if outside.any() else 0:.3g}")
        assert 1 - outside.mean() >= PARAM_SHARE, outside.mean()
        assert (least_mean[outside] <= NEAR_ZERO_GRAD).all(), least_mean[outside].max()
        assert got_opt.count == int(adam.count) == p
        for k, v in metrics.items():
            np.testing.assert_allclose(float(v), float(c["jmetrics"][k]), **METRIC_TOL,
                                       err_msg=k)
        np.testing.assert_allclose(float(sums[0]) / B, float(c["jmetrics"]["reward_per_env"]),
                                   rtol=1e-6)
        assert int(sums[1]) == int(c["jmetrics"]["episodes_done"])
    assert all(torch.equal(r[0][0], ranks[0][0][0]) for r in ranks)
