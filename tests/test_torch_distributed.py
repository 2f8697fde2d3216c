"""The port's ``distributed`` module on the CPU: JAX's four cases of
``tests/test_distributed.py`` (a single-process ``initialize`` is a no-op,
the global env batch, ``run_with_recovery``'s happy path and a restore after
an injected failure), and two gloo rank processes (``tests/torch_dp_worker``,
spawned once): per-rank checkpoints of a data-parallel run with the refusal
of another world size, and ``profiling.aggregate_across_hosts``."""
import pytest
import torch

import rware_tpu_torch
from rware_tpu_torch.checkpoint import Checkpointer
from rware_tpu_torch.distributed import global_env_batch, initialize, run_with_recovery
from rware_tpu_torch.models.ippo import IPPOConfig, build_train_step, init_runner
from rware_tpu_torch.parallel import batched_reset
from rware_tpu_torch.parallel.sharding import tree_map
from rware_tpu_torch.testing import dp_task, emulate_mesh
from tests import torch_dp_worker

torch.set_num_threads(1)

ENV_VARS = ("RWARE_COORD_ADDR", "RWARE_NUM_PROCS", "RWARE_PROC_ID", "RANK", "WORLD_SIZE",
            "MASTER_ADDR", "MASTER_PORT")


def leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def assert_tree_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_initialize_single_process_noop(monkeypatch):
    for k in ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    assert initialize() == (0, 1)
    assert not torch.distributed.is_initialized()


def test_global_env_batch_single_host_and_ranks():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu")

    def make_local(start, count):
        return batched_reset(env, 0, count, start)[0]

    whole = global_env_batch(make_local, 16)
    assert whole.agent_x.shape == (16, 2)
    parts = emulate_mesh(lambda mesh: global_env_batch(make_local, 16, mesh), 2)
    for r, part in enumerate(parts):
        assert part.agent_x.shape == (8, 2)
        assert_tree_equal(part, tree_map(lambda x: x[8 * r:8 * (r + 1)], whole))
    with pytest.raises(ValueError, match="not divisible"):
        emulate_mesh(lambda mesh: global_env_batch(make_local, 15, mesh), 2)


def _plain_ippo():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu")
    cfg = IPPOConfig(n_envs=8, rollout_len=4, epochs=1, minibatches=1)
    runner, dims = init_runner(env, cfg, 0, (32, 32))
    return runner, build_train_step(env, dims, cfg)


def test_run_with_recovery_happy_path(tmp_path):
    runner, train_step = _plain_ippo()
    ckpt = Checkpointer(str(tmp_path / "rec"))
    seen = []
    runner = run_with_recovery(train_step, runner, n_updates=4, checkpointer=ckpt,
                               checkpoint_every=2, on_metrics=lambda u, m: seen.append(u))
    assert runner.update_idx == 4
    assert seen == [1, 2, 3, 4]
    assert ckpt.latest_step == 4 and ckpt.steps() == [0, 2, 4]


def test_run_with_recovery_restores_after_failure(tmp_path):
    runner, real_step = _plain_ippo()
    unbroken = runner
    for _ in range(5):
        unbroken, _ = real_step(unbroken)
    runner, real_step = _plain_ippo()
    ckpt = Checkpointer(str(tmp_path / "rec2"))
    calls = {"n": 0}

    def flaky_step(r):
        calls["n"] += 1
        if calls["n"] == 4:  # fails once mid-run, after the checkpoint at 2
            raise RuntimeError("injected device failure")
        return real_step(r)

    runner = run_with_recovery(flaky_step, runner, n_updates=5, checkpointer=ckpt,
                               checkpoint_every=2, max_restarts=2)
    # the failure in update 4 rewound to the checkpoint of update 2 and replayed to 5
    assert runner.update_idx == 5 and calls["n"] == 7
    assert torch.equal(runner.params, unbroken.params)
    assert_tree_equal(runner.env_states, unbroken.env_states)
    calls["n"] = 0
    with pytest.raises(RuntimeError, match="injected"):
        run_with_recovery(flaky_step, _plain_ippo()[0], n_updates=5)  # no checkpointer


def test_checkpointer_world_size_naming(tmp_path):
    runner, _ = _plain_ippo()
    ckpt = Checkpointer(str(tmp_path), rank=1, world=2)
    ckpt.save(3, runner)
    assert ckpt.steps() == []  # rank 0's file is missing: the step is not complete
    Checkpointer(str(tmp_path), rank=0, world=2).save(3, runner)
    assert ckpt.steps() == [3] and ckpt.latest_step == 3
    with pytest.raises(ValueError, match="world size 2; this run has world size 1"):
        Checkpointer(str(tmp_path)).restore(template=runner)
    with pytest.raises(ValueError, match="rank 2 is not in a world of 2"):
        Checkpointer(str(tmp_path), rank=2, world=2)


CKPT_TASK = {"kind": "checkpoint", "name": "checkpoint", "env_id": "rware-tiny-2ag-v2",
             "cfg": {"n_envs": 64, "rollout_len": 4, "epochs": 1, "minibatches": 2},
             "seed": 3, "hidden": 32}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ranks"))
    tasks = [CKPT_TASK, {"kind": "aggregate", "name": "aggregate"}]
    procs = torch_dp_worker.spawn(tasks, 2, tmp)
    # the same two updates unbroken, the ranks emulated in this process
    unbroken = emulate_mesh(lambda mesh: dp_task(dict(CKPT_TASK, kind="learner", n_updates=2),
                                                 mesh), 2)
    return dict(torch_dp_worker.results(procs, tasks, tmp), unbroken=unbroken)


def test_per_rank_checkpoints_across_two_gloo_ranks(two_ranks):
    res = two_ranks["checkpoint"]
    want_files = [f"{s}.rank{r}-of2.pt" for s in (1, 2) for r in (0, 1)]
    for r, out in enumerate(res):
        assert out["steps"] == [1, 2] and sorted(out["files"]) == sorted(want_files)
        assert "world size 2; this run has world size 1" in out["refused"]
        assert_tree_equal(out["restored"], out["saved"])  # this rank's shard, bit for bit
        assert_tree_equal(out["restored"], two_ranks["unbroken"][r]["runner"])
    a, b = (out["saved"] for out in res)
    assert torch.equal(a["params"], b["params"])  # the replicated part is the same
    assert not torch.equal(a["env_states"]["agent_x"], b["env_states"]["agent_x"])
    assert a["env_states"]["agent_x"].shape == (32, 2)


def test_aggregate_across_hosts_two_gloo_ranks(two_ranks):
    for out in two_ranks["aggregate"]:
        assert out["mean"] == {"rank": 0.5, "same": 2.5}
        assert out["sum"] == {"rank": 1.0, "same": 5.0}
