"""Data-parallel training of the port on the CPU: two gloo rank processes
(``tests/torch_dp_worker``, spawned once for the file), each holding half of
the global env batch.

* IPPO (K4 per pass) and recurrent IPPO against the JAX package's 2-device
  mesh step, ``build_pallas_train_step`` / ``build_rnn_pallas_train_step``
  with ``mesh=make_mesh(jax.devices()[:2]), interpret=True,
  deterministic_collect=True``, from JAX's parameters, optimizer state and
  env states, with JAX's window starts / epoch offsets handed over;
  tiny-2ag, B=2,048, T=8, E=1, M=2.  Tolerances as
  ``tests/test_torch_train.py``'s: parameters within 0.05 * lr * P, rtol
  1e-3; metrics rtol 1e-2.
* Every learner that trains under a mesh (``testing.DP_LEARNERS``): the five
  JAX builds with ``mesh=`` (IPPO, recurrent IPPO with and without the fused
  loss, MAPPO, recurrent MAPPO, recurrent SEAC-PPO; per-shard statistics)
  and the five it only places on a mesh (plain IPPO, plain recurrent IPPO,
  SEAC-PPO on K8, SEAC-PPO's flat learner with two message bits, SEAC A2C;
  whole-batch statistics), in random mode against the in-process emulation
  of two ranks (``testing.emulate_mesh``: the same kernels' plain versions on
  each shard, the same collectives, the same optimizer step), bit for bit;
  the parameters bit-equal across ranks; each rank's first trajectory equal
  to its rows of the 1-rank global collect; E * M + 1 all-reduces an update
  (SEAC A2C: 2) and none in the collect.
* The refusals: K3 and ``fused_critic_phase`` under a mesh, and ``train
  --distributed`` over two processes without ``--mesh``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from rware_tpu.models import IPPOConfig as JaxConfig
from rware_tpu.models import ippo_pallas as jax_native
from rware_tpu.models import ippo_rnn as jax_rnn
from rware_tpu.models.networks import RecurrentActorCritic as FlaxRecurrent
from rware_tpu.ops.pallas_rollout import LANE
from rware_tpu.ops.pallas_update import phase_time_block as jax_time_block
from rware_tpu.parallel import make_mesh as jax_make_mesh
from rware_tpu_torch import train
from rware_tpu_torch.convert import adam_state_from_optax, gru_params_from_flax, params_from_flax
from rware_tpu_torch.models.ippo import IPPOConfig
from rware_tpu_torch.parallel.sharding import Mesh
from rware_tpu_torch.testing import DP_LEARNERS, dp_task, emulate_mesh
from tests import torch_dp_worker
from tests.torch_ref import jit_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

JB, T_LEN, EPOCHS, MINIBATCHES, HG = 2048, 8, 1, 2, 32  # the JAX comparisons
RB, R_EPOCHS, N_UPDATES = 256, 2, 2  # the random-mode learners
ENV = "rware-tiny-2ag-v2"


def jax_ippo_case():
    jenv, _ = make_pair(ENV)
    jcfg = JaxConfig(n_envs=JB, rollout_len=T_LEN, epochs=EPOCHS, minibatches=MINIBATCHES)
    jrunner, model, tx = jax_native.init_pallas_runner(jenv, jcfg, jax.random.key(0))
    k_perm = jax.random.split(jrunner.key, 2)[1]
    starts = jax_native.phase_window_starts(jcfg, T_LEN, jax_time_block(T_LEN // MINIBATCHES),
                                            k_perm)
    task = {"kind": "learner", "name": "ippo_jax", "learner": "ippo", "env_id": ENV,
            "cfg": dict(n_envs=JB, rollout_len=T_LEN, epochs=EPOCHS, minibatches=MINIBATCHES),
            "seed": 0, "hidden": 128, "deterministic": True, "n_updates": 1,
            "windows": [np.array(starts).astype(np.int64)],
            "override": {"params": params_from_flax(jax.tree.map(np.asarray, jrunner.params)),
                         "opt_state": adam_state_from_optax(
                             jax.tree.map(np.asarray, jrunner.opt_state)),
                         "env_states": to_port(jrunner.env_states)}}

    def run():
        ts = jax_native.build_pallas_train_step(
            jenv, model, tx, jcfg, interpret=True, deterministic_collect=True,
            mesh=jax_make_mesh(jax.devices()[:2]))
        jnew, jmetrics = jit_bf16_exact(ts, jrunner)
        return params_from_flax(jax.tree.map(np.asarray, jnew.params)), jmetrics

    return task, run


def jax_rnn_case():
    jenv, _ = make_pair(ENV)
    jcfg = JaxConfig(n_envs=JB, rollout_len=T_LEN, epochs=EPOCHS, minibatches=MINIBATCHES)
    model = FlaxRecurrent(n_actions=5, hidden=HG, embed=HG)
    jrunner, model, tx = jax_rnn.init_rnn_runner(jenv, jcfg, jax.random.key(1), model)
    rng = np.random.default_rng(5)
    biased = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.2 * rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "bias" else x, jrunner.params)
    jrunner = jrunner.replace(params=biased, opt_state=tx.init(biased))
    k_perm = jax.random.split(jrunner.key, 2)[1]
    rb = JB // 2 // LANE  # the rows of a shard (ippo_rnn.py:826)
    offsets = [int(jax.random.randint(k, (), 0, rb)) for k in jax.random.split(k_perm, EPOCHS)]
    task = {"kind": "learner", "name": "rnn_ippo_jax", "learner": "rnn_ippo", "env_id": ENV,
            "cfg": dict(n_envs=JB, rollout_len=T_LEN, epochs=EPOCHS, minibatches=MINIBATCHES),
            "seed": 1, "hidden": HG, "deterministic": True, "n_updates": 1,
            "windows": [offsets],
            "override": {"params": gru_params_from_flax(jax.tree.map(np.asarray, biased)),
                         "opt_state": adam_state_from_optax(
                             jax.tree.map(np.asarray, jrunner.opt_state),
                             from_flax=gru_params_from_flax),
                         "env_states": to_port(jrunner.env_states),
                         "carry": torch.zeros((JB, 2, HG), dtype=torch.bfloat16)}}

    def run():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_rnn, "GRU_SEQ_IMPL", "pallas_interpret")
            ts = jax_rnn.build_rnn_pallas_train_step(
                jenv, model, tx, jcfg, interpret=True, deterministic_collect=True,
                mesh=jax_make_mesh(jax.devices()[:2]))
            jnew, jmetrics = jit_bf16_exact(ts, jrunner)
        return gru_params_from_flax(jax.tree.map(np.asarray, jnew.params)), jmetrics

    return task, run


def random_task(learner):
    overrides = {"max_steps": 6}  # episodes end inside both updates
    if learner == "seac_flat":
        overrides["msg_bits"] = 2  # the learner SEAC-PPO with message bits trains on
    return {"kind": "learner", "name": learner, "learner": learner, "env_id": ENV,
            "env_overrides": overrides,
            "cfg": dict(n_envs=RB, rollout_len=T_LEN, epochs=R_EPOCHS, minibatches=MINIBATCHES),
            "seed": 4, "hidden": HG, "n_updates": N_UPDATES}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The rank processes' results, and beside them JAX's mesh steps, the
    emulated two ranks and the global (one-rank, no mesh) runs, computed
    while the ranks run."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    (ippo_task, ippo_jax), (rnn_task, rnn_jax) = jax_ippo_case(), jax_rnn_case()
    tasks = [ippo_task, rnn_task] + [random_task(name) for name in DP_LEARNERS]
    procs = torch_dp_worker.spawn(tasks, 2, tmp)
    try:
        local = {}
        for task in tasks[2:]:
            local[task["name"]] = {"emulated": emulate_mesh(lambda mesh: dp_task(task, mesh), 2),
                                   "global": dp_task(task, None)}
        jax_out = {"ippo_jax": ippo_jax(), "rnn_ippo_jax": rnn_jax()}
    except BaseException:
        for proc in procs:
            proc.kill()
        raise
    ranks = torch_dp_worker.results(procs, tasks, tmp)
    return {"ranks": ranks, "local": local, "jax": jax_out}


@pytest.mark.parametrize("name", ["ippo_jax", "rnn_ippo_jax"])
def test_two_ranks_match_jax_mesh_step(runs, name):
    want, jmetrics = runs["jax"][name]
    p = EPOCHS * MINIBATCHES
    lr = IPPOConfig().lr
    for out in runs["ranks"][name]:
        np.testing.assert_allclose(out["runner"]["params"].numpy(), want.numpy(),
                                   atol=0.05 * lr * p, rtol=1e-3)
        assert out["runner"]["update_idx"] == 1 and out["runner"]["opt_state"]["count"] == p
        for k, v in out["metrics"][0].items():
            np.testing.assert_allclose(v, float(jmetrics[k]), rtol=1e-2, atol=1e-6, err_msg=k)
    a, b = (out["runner"]["params"] for out in runs["ranks"][name])
    assert torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _replicated(packed):
    return {k: packed[k] for k in ("params", "opt_state")}


@pytest.mark.parametrize("name", DP_LEARNERS)
def test_two_ranks_equal_the_emulation_bit_for_bit(runs, name):
    ranks, emulated = runs["ranks"][name], runs["local"][name]["emulated"]
    for got, want in zip(ranks, emulated):
        for x, y in zip(_leaves(got["runner"]), _leaves(want["runner"])):
            assert x.dtype == y.dtype and torch.equal(x, y)
        assert got["metrics"] == want["metrics"]
    for x, y in zip(_leaves(_replicated(ranks[0]["runner"])),
                    _leaves(_replicated(ranks[1]["runner"]))):
        assert torch.equal(x, y)  # every rank took the same steps
    m = ranks[0]["metrics"]
    assert m == ranks[1]["metrics"] and all(u["episodes_done"] > 0 for u in m)


@pytest.mark.parametrize("name", DP_LEARNERS)
def test_rank_trajectory_is_its_rows_of_the_global_collect(runs, name):
    whole = runs["local"][name]["global"]["traj"]
    for r, out in enumerate(runs["ranks"][name]):
        for k, v in whole.items():
            assert torch.equal(out["traj"][k], v[:, r * RB // 2:(r + 1) * RB // 2]), k


@pytest.mark.parametrize("name", DP_LEARNERS + ("ippo_jax", "rnn_ippo_jax"))
def test_collectives_per_update(runs, name):
    epochs = EPOCHS if name.endswith("_jax") else R_EPOCHS
    # SEAC A2C: the gradients and metrics, then the reward sums
    per_update = 2 if name == "seac_a2c" else epochs * MINIBATCHES + 1
    for out in runs["ranks"][name]:
        assert out["collect_counts"] == {"all_reduce": 0, "broadcast": 0}
        assert all(c == {"all_reduce": per_update, "broadcast": 0}
                   for c in out["update_counts"])


def test_whole_phase_kernels_are_refused_under_a_mesh():
    import rware_tpu_torch
    from rware_tpu_torch.models import ippo, mappo
    from rware_tpu_torch.models.ippo_fused import build_fused_train_step

    env = rware_tpu_torch.make(ENV, device="cpu")
    cfg = IPPOConfig(n_envs=64, rollout_len=4, minibatches=2)
    mesh = Mesh(None, 0, 2, "cpu")
    _, dims = ippo.init_runner(env, cfg, 0, (32, 32))
    with pytest.raises(ValueError, match="in-kernel, so it is incompatible with the per-minibatch"):
        build_fused_train_step(env, dims, cfg, fused_update_phase=True, mesh=mesh)
    assert build_fused_train_step(env, dims, cfg, mesh=mesh).update_phase is None
    assert build_fused_train_step(env, dims, cfg).update_phase is not None
    _, adims, cdims = mappo.init_mappo_runner(env, cfg, 0, (32, 32), (32, 32))
    with pytest.raises(ValueError, match="fused_critic_phase .*pmean of the mesh path"):
        mappo.build_mappo_train_step(env, adims, cdims, cfg, fused_critic_phase=True, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible by the world size 2"):
        build_fused_train_step(env, dims, dataclasses.replace(cfg, n_envs=63), mesh=mesh)


def test_train_distributed_over_ranks_needs_the_mesh(monkeypatch, tmp_path):
    import rware_tpu_torch.distributed as distributed

    monkeypatch.setattr(distributed, "initialize", lambda **kw: (1, 2))
    with pytest.raises(ValueError, match="over 2 processes needs --mesh"):
        train.main(["--device", "cpu", "--distributed", "--n-envs", "64", "--updates", "1",
                    "--checkpoint-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # refused before anything was written
