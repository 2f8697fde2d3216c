"""The semantics of the learners JAX only places on a device mesh, on the
CPU: ``train.py:291-303`` places the runner of plain IPPO
(``ippo.build_train_step``) and of SEAC A2C (``seac.build_seac_train_step``)
on a mesh without a ``shard_map`` (env states and observations split over
the devices, parameters and optimizer state replicated), and XLA's
partitioner keeps the single-device meaning: every statistic is the whole
batch's.  tiny-2ag, hidden (32, 32), B=32; IPPO T=8, E=2, M=2; A2C T=5;
``jax.devices()[:2]``; both compiled without XLA's excess precision.

* Plain IPPO placed equals the unplaced step bit for bit.
* SEAC A2C placed: the loss terms within rtol 1e-6, the collect bit for bit;
  XLA sums each device's part of a weight's bf16 gradient, so Adam's first
  moment (the gradient) differs within 5% of each leaf's largest magnitude and the parameters
  within lr (Adam's first step turns a flipped rounding of a near-zero
  gradient into a move of up to lr).

SEAC-PPO's flat learner placed equals the unplaced step bit for bit
(``tests/test_torch_dp_placement_semantics_seac.py``), and plain recurrent
IPPO placed meets the unplaced step to the order of float sums
(``tests/test_torch_dp_placement_semantics_rnn.py``); each file stays under
a minute.
"""
import jax
import numpy as np

from rware_tpu.models import ippo as jax_ippo
from rware_tpu.models import ippo_rnn as jax_rnn
from rware_tpu.models import seac as jax_seac
from rware_tpu.models.networks import ActorCritic as FlaxActorCritic
from rware_tpu.models.networks import RecurrentActorCritic as FlaxRecurrent
from rware_tpu.parallel import make_mesh, replicate, shard_env_batch
from tests.torch_ref import jit_bf16_exact, make_pair

ENV = "rware-tiny-2ag-v2"
T_LEN, EPOCHS, MINIBATCHES = 8, 2, 2
GRAD_TOL = 0.05  # of each leaf's largest magnitude


def _mesh():
    return make_mesh(jax.devices()[:2])


def place(runner, mesh):
    """The runner as ``train.py:291-303`` places it (the carry too, where the
    runner has one)."""
    runner = runner.replace(env_states=shard_env_batch(runner.env_states, mesh),
                            obs=shard_env_batch(runner.obs, mesh),
                            params=replicate(runner.params, mesh),
                            opt_state=replicate(runner.opt_state, mesh))
    if hasattr(runner, "carry"):
        runner = runner.replace(carry=shard_env_batch(runner.carry, mesh))
    return runner


def _bits(tree):
    """Every leaf as numpy (keys as their data)."""
    def leaf(x):
        if jax.dtypes.issubdtype(getattr(x, "dtype", None), jax.dtypes.prng_key):
            x = jax.random.key_data(x)
        return np.asarray(x)

    return [leaf(x) for x in jax.tree.leaves(tree)]


def _equal_bits(a, b):
    la, lb = _bits(a), _bits(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and x.shape == y.shape
                                      and x.tobytes() == y.tobytes() for x, y in zip(la, lb))


def _step(algo):
    """(JAX's runner, its step) of plain IPPO, SEAC A2C or SEAC-PPO's flat
    learner at hidden (32, 32), or plain recurrent IPPO at embed and GRU 32."""
    jenv, _ = make_pair(ENV)
    model = FlaxActorCritic(n_actions=jenv.n_actions, hidden=(32, 32))
    if algo == "rnn_ippo":
        cfg = jax_ippo.IPPOConfig(n_envs=32, rollout_len=T_LEN, epochs=EPOCHS,
                                  minibatches=MINIBATCHES)
        runner, model, tx = jax_rnn.init_rnn_runner(
            jenv, cfg, jax.random.key(3),
            FlaxRecurrent(n_actions=jenv.n_actions, hidden=32, embed=32))
        return runner, jax_rnn.build_rnn_train_step(jenv, model, tx, cfg)
    if algo == "seac_ppo":
        cfg = jax_seac.SEACPPOConfig(n_envs=32, rollout_len=T_LEN, epochs=EPOCHS,
                                     minibatches=MINIBATCHES)
        runner, model, tx = jax_seac.init_seac_ppo(jenv, cfg, jax.random.key(3), model)
        return runner, jax_seac.build_seac_ppo_train_step(jenv, model, tx, cfg, update_mode="xla")
    if algo == "ippo":
        cfg = jax_ippo.IPPOConfig(n_envs=32, rollout_len=T_LEN, epochs=EPOCHS,
                                  minibatches=MINIBATCHES)
        runner, model, tx = jax_ippo.init_runner(jenv, cfg, jax.random.key(3), model)
        return runner, jax_ippo.build_train_step(jenv, model, tx, cfg)
    cfg = jax_seac.SEACConfig(n_envs=32, rollout_len=5)
    runner, model, tx = jax_seac.init_seac(jenv, cfg, jax.random.key(3), model)
    return runner, jax_seac.build_seac_train_step(jenv, model, tx, cfg)


def test_jax_placed_ippo_step_equals_unplaced():
    runner, step = _step("ippo")
    unplaced = jit_bf16_exact(step, runner)
    placed = jit_bf16_exact(step, place(runner, _mesh()))
    assert _equal_bits(unplaced, placed)
    assert float(unplaced[1]["entropy"]) > 0  # the step ran


def test_jax_placed_a2c_step_matches_unplaced():
    """SEAC A2C placed: the same loss terms to float order; the gradient
    differs where XLA sums each device's part of a weight's bf16 gradient
    (Adam's first moment within 5% of each leaf's largest magnitude), and Adam's
    first step lifts that to at most lr in a parameter."""
    runner, step = _step("seac_a2c")
    (new, metrics), (pnew, pmetrics) = (jit_bf16_exact(step, r)
                                        for r in (runner, place(runner, _mesh())))
    assert set(metrics) == set(pmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(pmetrics[k]), float(v), rtol=1e-6, err_msg=k)
    for a, b in zip(*(jax.tree.leaves(r.opt_state[1][0].mu) for r in (new, pnew))):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(b, a, atol=GRAD_TOL * np.abs(a).max())
    for a, b in zip(jax.tree.leaves(new.params), jax.tree.leaves(pnew.params)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=jax_seac.SEACConfig().lr)
    assert _equal_bits(new.env_states, pnew.env_states)  # the collect is the same
