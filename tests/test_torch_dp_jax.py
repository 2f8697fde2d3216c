"""Data-parallel MAPPO and recurrent MAPPO against the JAX package's 2-device
mesh steps on the CPU (recurrent SEAC-PPO's case, :func:`jax_case`
``"seac_gru"``, runs in ``tests/test_torch_dp_jax_seac.py``, so that each file
stays under a minute): two gloo rank processes
(``tests/torch_dp_worker``, spawned once for the file) each hold half of the
global batch, from JAX's parameters, optimizer state, env states and carry,
with JAX's window starts / epoch offsets handed over, while this process
runs ``build_mappo_train_step`` (K5 per pass, ``fused_critic_update=True``),
``build_rnn_mappo_train_step`` and ``build_seac_gru_train_step`` with
``mesh=make_mesh(jax.devices()[:2]), interpret=True,
deterministic_collect=True``.  tiny-2ag, B=2,048 (1,024 a shard: JAX's
ENV_BLOCK), T=8, M=2, E as each learner's single-process test takes it (2,
1 and 2), one update.  Under the mesh each shard normalises
its own advantages and SEAC's and the recurrent learners' offsets fall in
the shard's rows, so these hold the port's shard semantics to JAX's.

Tolerances as the learners' single-process tests
(``tests/test_torch_mappo_train.py``, ``test_torch_rnn_mappo_train.py``,
``test_torch_seac_gru_train.py``): parameters within 0.05 * lr * P, rtol
1e-3; metrics within rtol 1e-2, atol 1e-4 (SEAC's ``approx_kl`` atol 2e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rware_tpu.models import IPPOConfig as JaxConfig
from rware_tpu.models import ippo_pallas as jax_native
from rware_tpu.models import ippo_rnn as jax_rnn
from rware_tpu.models import mappo as jax_mappo
from rware_tpu.models import seac as jax_seac
from rware_tpu.models.networks import CentralCritic as FlaxCritic
from rware_tpu.models.networks import RecurrentActorCritic as FlaxRecurrent
from rware_tpu.ops.pallas_rollout import LANE
from rware_tpu.ops.pallas_update import phase_time_block as jax_time_block
from rware_tpu.parallel import make_mesh as jax_make_mesh
from rware_tpu_torch.convert import (
    critic_params_from_flax,
    gru_params_from_flax,
    mappo_opt_state_from_optax,
    mappo_params_from_flax,
    params_from_flax,
    seac_opt_state_from_optax,
    seac_params_from_flax,
)
from rware_tpu_torch.models.ippo import IPPOConfig
from tests import torch_dp_worker
from tests.torch_ref import jit_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

JB, T_LEN, MINIBATCHES, HG = 2048, 8, 2, 32
EPOCHS = {"mappo": 2, "rnn_mappo": 1, "seac_gru": 2}
N_LOCAL = JB // 2
ENV = "rware-tiny-2ag-v2"
CASES = ("mappo", "rnn_mappo")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _biased(params, seed):
    """``params`` with every bias moved off zero: a zero bias hides where it is rounded."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.2 * rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "bias" else x, params)


def _carry(jrunner):
    return torch.from_numpy(np.array(jrunner.carry.astype(jnp.float32))).to(torch.bfloat16)


def _offsets(key, n_split, which, high, epochs):
    """The E offsets a recurrent update draws from ``split(key, n_split)[which]``."""
    k_perm = jax.random.split(key, n_split)[which]
    return [int(jax.random.randint(k, (), 0, high)) for k in jax.random.split(k_perm, epochs)]


def _mesh():
    return jax_make_mesh(jax.devices()[:2])


def jax_case(name):
    """(the ranks' task, a function running JAX's mesh step that returns
    (the port's flat parameters of JAX's result, JAX's metrics))."""
    jenv, _ = make_pair(ENV)
    kw = dict(n_envs=JB, rollout_len=T_LEN, epochs=EPOCHS[name], minibatches=MINIBATCHES)
    hidden, interpret_gru = 128, False
    if name == "mappo":
        jcfg = JaxConfig(**kw)
        jrunner, actor, critic, tx = jax_mappo.init_mappo_runner(jenv, jcfg, jax.random.key(2))
        k_perm = jax.random.split(jrunner.key, 3)[1]  # mappo.py:581
        windows = np.array(jax_native.phase_window_starts(
            jcfg, T_LEN, jax_time_block(T_LEN // MINIBATCHES), k_perm)).astype(np.int64)

        def flat(params):
            params = _np(params)
            return {"actor": params_from_flax(params["actor"]),
                    "critic": critic_params_from_flax(params["critic"])}

        over = {"params": flat(jrunner.params),
                "opt_state": mappo_opt_state_from_optax(_np(jrunner.opt_state))}

        def build():
            return jax_mappo.build_mappo_train_step(
                jenv, actor, critic, tx, jcfg, interpret=True, deterministic_collect=True,
                fused_critic_update=True, mesh=_mesh())
    elif name == "rnn_mappo":
        jcfg, hidden, interpret_gru = JaxConfig(**kw), HG, True
        actor = FlaxRecurrent(n_actions=5, hidden=HG, embed=HG)
        critic = FlaxCritic(n_agents=2, hidden=(HG, HG))
        jrunner, actor, critic, tx = jax_mappo.init_rnn_mappo_runner(
            jenv, jcfg, jax.random.key(3), actor, critic)
        params = _biased(jrunner.params, 5)
        jrunner = jrunner.replace(params=params, opt_state=tx.init(params))
        # mappo.py:890, 972; rb = n_local / LANE
        windows = _offsets(jrunner.key, 2, 1, N_LOCAL // LANE, jcfg.epochs)

        def flat(params):
            return mappo_params_from_flax(_np(params), actor_from_flax=gru_params_from_flax)

        over = {"params": flat(jrunner.params),
                "opt_state": mappo_opt_state_from_optax(_np(jrunner.opt_state),
                                                        actor_from_flax=gru_params_from_flax),
                "carry": _carry(jrunner)}

        def build():
            return jax_mappo.build_rnn_mappo_train_step(
                jenv, actor, critic, tx, jcfg, interpret=True, deterministic_collect=True,
                mesh=_mesh())
    else:
        jcfg, hidden, interpret_gru = jax_seac.SEACPPOConfig(**kw), HG, True
        model = FlaxRecurrent(n_actions=5, hidden=HG, embed=HG)
        jrunner, model, tx = jax_seac.init_seac_gru(jenv, jcfg, jax.random.key(4), model)
        params = _biased(jrunner.params, 6)
        jrunner = jrunner.replace(params=params, opt_state=tx.init(params))
        # seac.py:1024, 1110: offsets in [0, n_local)
        windows = _offsets(jrunner.key, 3, 2, N_LOCAL, jcfg.epochs)

        def flat(params):
            return seac_params_from_flax(_np(params))

        over = {"params": flat(jrunner.params),
                "opt_state": seac_opt_state_from_optax(_np(jrunner.opt_state)),
                "carry": _carry(jrunner)}

        def build():
            return jax_seac.build_seac_gru_train_step(
                jenv, model, tx, jcfg, collect_mode="pallas", interpret=True,
                deterministic_collect=True, mesh=_mesh())
    over["env_states"] = to_port(jrunner.env_states)
    task = {"kind": "learner", "name": name, "learner": name, "env_id": ENV, "cfg": kw,
            "seed": 0, "hidden": hidden, "deterministic": True, "n_updates": 1,
            "windows": [windows], "override": over}

    def run():
        with pytest.MonkeyPatch.context() as mp:
            if interpret_gru:  # on the CPU "auto" would take the XLA scan
                mp.setattr(jax_rnn, "GRU_SEQ_IMPL", "pallas_interpret")
            jnew, jmetrics = jit_bf16_exact(build(), jrunner)
        return flat(jnew.params), {k: float(v) for k, v in jmetrics.items()}

    return task, run


def run_cases(names, tmp):
    """(the rank processes' results, JAX's mesh steps computed in this
    process while the ranks run) of the cases ``names``."""
    cases = {name: jax_case(name) for name in names}
    tasks = [cases[name][0] for name in names]
    procs = torch_dp_worker.spawn(tasks, 2, tmp)
    try:
        jax_out = {name: cases[name][1]() for name in names}
    except BaseException:
        for proc in procs:
            proc.kill()
        raise
    return torch_dp_worker.results(procs, tasks, tmp), jax_out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(CASES, str(tmp_path_factory.mktemp("dpjax")))


def _flat(params):
    return params if isinstance(params, dict) else {"": params}


def check_against_jax(runs, name):
    """Each rank's parameters and metrics against JAX's mesh step; the
    ranks' parameters bit-equal."""
    ranks, jax_out = runs
    want, jmetrics = jax_out[name]
    p = EPOCHS[name] * MINIBATCHES
    lr = IPPOConfig().lr
    for out in ranks[name]:
        runner = out["runner"]
        for part, x in _flat(runner["params"]).items():
            np.testing.assert_allclose(x.numpy(), _flat(want)[part].numpy(),
                                       atol=0.05 * lr * p, rtol=1e-3, err_msg=part)
        assert runner["update_idx"] == 1
        metrics = out["metrics"][0]
        assert set(metrics) == set(jmetrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(v, jmetrics[k], rtol=1e-2,
                                       atol=2e-3 if k == "approx_kl" and name == "seac_gru"
                                       else 1e-4, err_msg=k)
    a, b = (_flat(out["runner"]["params"]) for out in ranks[name])
    assert all(torch.equal(a[k], b[k]) for k in a)  # the ranks took the same step


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_match_jax_mesh_step(runs, name):
    check_against_jax(runs, name)
