"""SEAC A2C's updates on the CPU: the port's ``SeacA2CTrainStep.update``
handed the JAX package's own trajectories, three chained updates across
episode ends against ``build_seac_train_step``'s ``train_step`` (M=0 and M=2
message bits), and the port's own rollout through the per-agent collector's
plain version.

The trajectory is JAX's ``collect`` closure scanned over the same
``roll_keys`` as its ``train_step``, compiled with it as one program without
XLA's excess precision (``tests/torch_ref.compile_bf16_exact``); parameters
and optimizer state go through ``rware_tpu_torch.convert`` from JAX's
``init_seac`` with the biases moved off zero, and each side carries its own
from then on.

Tolerances.  After P chained updates (one Adam step each) at least 99.9% of
the parameters within 0.05 * lr * P (rtol 1e-3), the bound of the other
learners' chained tests, and every parameter outside it one whose gradient
was near zero: JAX's bias-corrected Adam mean |mu / (1 - 0.9^k)| at most
``NEAR_ZERO_GRAD`` = 3e-5 (three times Adam's eps) after some update k <= P.
Adam's first steps move such a parameter by ``lr * g / (|g| + 1e-5)``, so a
difference in ``g`` of a bf16 rounding (2e-6 where |g| is 1e-6; the
gradients agree to 0.7% of the largest) moves the step by up to lr, and the
difference is carried into the later updates (0.02-0.03% of the parameters,
0.25 * lr and 0.87 * lr at M=0 and M=2 after the first update, every one
with that mean at most 1.24e-5).  The Adam moments within ``GRAD_TOL`` (5%) of each leaf's
largest |mu| and twice that of its largest |nu| (nu is the square of the
gradient: its error is about twice the gradient's); the optimizer count
exact; the loss metrics within rtol 2e-2, atol 2e-3, and ``reward_per_env``
/ ``episodes_done`` exact (sums of the one trajectory both sides take).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.models import seac as jax_seac
from rware_tpu_torch import convert
from rware_tpu_torch.models import ippo, seac
from rware_tpu_torch.models.networks import BlockDims
from tests.test_torch_seac_a2c import (
    GRAD_TOL,
    LOSS_KEYS,
    METRIC_TOL,
    L,
    N,
    assert_stack_close,
    biased,
    closure_fn,
    port_traj,
)
from tests.torch_ref import compile_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

T_LEN, B_CHAIN, MAX_STEPS, N_UPDATES = 5, 128, 6, 3  # episodes end in updates 2 and 3
NEAR_ZERO_GRAD = 3e-5  # JAX's bias-corrected Adam mean that counts as a near-zero gradient
ADAM_B1 = 0.9  # optax's default, init_seac's chain


@pytest.fixture(scope="module", params=[0, 2], ids=["M0", "M2"])
def chained(request):
    """N_UPDATES updates of JAX's ``train_step`` and of the port's ``update``
    on the trajectory JAX's collect takes from the same runner; each side
    carries its own parameters and optimizer state."""
    m = request.param
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", max_steps=MAX_STEPS,
                                         msg_bits=m).config)
    jcfg = jax_seac.SEACConfig(n_envs=B_CHAIN, rollout_len=T_LEN)
    jrunner, model, tx = jax_seac.init_seac(jenv, jcfg, jax.random.key(1))
    params = jax.tree.map(jnp.asarray, biased(jrunner.params, 5, 0.2))
    jrunner = jrunner.replace(params=params, opt_state=tx.init(params))
    step_fn = jax_seac.build_seac_train_step(jenv, model, tx, jcfg)
    collect = closure_fn(step_fn, "collect")

    def jax_rollout(r):  # the first lines of train_step (seac.py:234-238)
        _, k_roll = jax.random.split(r.key)
        (_, _, obs), traj = jax.lax.scan(collect, (r.params, r.env_states, r.obs),
                                         jax.random.split(k_roll, jcfg.rollout_len))
        return traj, obs

    # one program: the rollout of train_step and the one handed to the port are
    # the same computation
    ts = compile_bf16_exact(lambda r: (step_fn(r), jax_rollout(r)), jrunner)
    cfg = seac.SEACConfig(n_envs=B_CHAIN, rollout_len=T_LEN)
    dims = BlockDims(env.config.policy_obs_length, 128, 128, 5, m)
    step = seac.build_seac_train_step(env, dims, cfg)
    runner = ippo.RunnerState(
        params=convert.seac_params_from_flax(jax.tree.map(np.asarray, jrunner.params)),
        opt_state=convert.seac_opt_state_from_optax(jax.tree.map(np.asarray, jrunner.opt_state)),
        env_states=to_port(jrunner.env_states), obs=None, generator=torch.Generator(),
        update_idx=0, seed=0)
    history = []
    for _ in range(N_UPDATES):
        (jrunner, jmetrics), (traj, last_obs) = ts(jrunner)
        ptraj = port_traj(traj, m)
        (params, opt_state), loss_metrics = step.update(runner, ptraj,
                                                        torch.from_numpy(np.asarray(last_obs)))
        runner = dataclasses.replace(runner, params=params, opt_state=opt_state,
                                     update_idx=runner.update_idx + 1)
        history.append((jrunner, jmetrics, runner, ippo.update_metrics(cfg, ptraj, loss_metrics)))
    return cfg, dims, history, step


def test_chained_updates_cross_episode_ends(chained):
    _, _, history, step = chained
    done = [int(h[3]["episodes_done"]) for h in history]
    assert done[0] == 0 and min(done[1:]) >= B_CHAIN, done
    assert step.collect.launches == 0  # the update takes JAX's trajectory; no collector ran


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_chained_update_matches_jax(chained, u):
    """After update u + 1: 99.9% of the parameters within 0.05 * lr * (u +
    1) and every other one with a near-zero gradient in JAX's Adam mean after
    some update so far, the Adam moments within GRAD_TOL (2 GRAD_TOL for nu)
    of each leaf's largest, the count exact, every metric as JAX's (``-s``
    prints the parameters' readings)."""
    cfg, dims, history, _ = chained
    jrunner, jmetrics, runner, metrics = history[u]

    def flat(tree):
        return convert.seac_params_from_flax(jax.tree.map(np.asarray, tree)).numpy()

    want = flat(jrunner.params)
    diff = np.abs(runner.params.numpy() - want)
    outside = diff > 0.05 * cfg.lr * (u + 1) + 1e-3 * np.abs(want)
    least_mean = np.min([np.abs(flat(history[k][0].opt_state[1][0].mu)) / (1 - ADAM_B1 ** (k + 1))
                         for k in range(u + 1)], axis=0)
    print(f"SEAC A2C M={dims.msg_bits} update {u + 1}: max |port - JAX| {diff.max():.4g}, "
          f"{1 - outside.mean():.6f} of the parameters within 0.05 lr P, the rest's least "
          f"Adam mean {least_mean[outside].max() if outside.any() else 0:.3g}")
    assert outside.mean() <= 0.001
    assert (least_mean[outside] <= NEAR_ZERO_GRAD).all(), least_mean[outside].max()
    adam = jrunner.opt_state[1][0]
    assert runner.opt_state.count == int(adam.count) == u + 1
    assert_stack_close(runner.opt_state.mu, adam.mu, dims, GRAD_TOL, "mu")
    assert_stack_close(runner.opt_state.nu, adam.nu, dims, 2 * GRAD_TOL, "nu")
    assert set(metrics) == set(jmetrics)
    for k in ("reward_per_env", "episodes_done"):
        assert float(metrics[k]) == float(jmetrics[k]), k
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), err_msg=k,
                                   **METRIC_TOL)


def test_train_step_collects_and_learns_something():
    """The port's own rollout: T=5 steps of the per-agent collector's plain
    version on a CPU runner, the same update again with ``collect="plain"``;
    every block of every agent moves."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu", max_steps=4)
    cfg = seac.SEACConfig(n_envs=16)
    runner, dims = seac.init_seac(env, cfg, seed=0)
    step = seac.build_seac_train_step(env, dims, cfg)
    new, metrics = step(runner)
    plain, _ = seac.build_seac_train_step(env, dims, cfg, collect="plain")(runner)
    assert torch.equal(new.params, plain.params)
    assert step.collect.launches == 0  # CPU: the plain version
    assert new.update_idx == 1 and new.opt_state.count == 1 and new.obs.shape == (16, 2, L)
    assert set(metrics) == {"reward_per_env", "episodes_done", *LOSS_KEYS}
    assert int(metrics["episodes_done"]) == 16  # episodes of 4 steps end in the rollout
    assert float(metrics["entropy"]) > 0.85 * np.log(5)  # near-uniform policies at init
    for i in range(N):
        for k, (a, b) in enumerate(zip(dims.split(runner.params[i]), dims.split(new.params[i]))):
            assert float((a - b).abs().max()) > 0, f"agent {i} block {k} did not move"
    with pytest.raises(ValueError, match="collect"):
        seac.build_seac_train_step(env, dims, cfg, collect="xla")
