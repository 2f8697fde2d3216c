"""``train --distributed --mesh`` over two gloo rank processes on the CPU
(``tests/torch_dp_worker``, spawned once for the file) for the learners JAX
only places on a mesh: plain IPPO (``--collect plain``), plain recurrent IPPO
(``--net gru --collect plain``), SEAC-PPO on K8 (``--algo seac-ppo``; its
plain version here), SEAC-PPO's flat learner with two message bits
(``--algo seac-ppo --msg-bits 2``) and SEAC A2C (``--algo seac``).  Each
case runs ``train.main`` for one update in the ranks' process group (which
it keeps), writing rank 0's ``policy.pt`` and each rank's runner, then
``--resume`` to two updates: the per-rank files of both steps are there, the
ranks' parameters are equal, and the resumed run says where it resumed.
"""
import os

import pytest
import torch

from rware_tpu_torch.checkpoint import pack
from rware_tpu_torch.testing import digest
from tests import torch_dp_worker

torch.set_num_threads(1)

CASES = {"plain": ["--collect", "plain"],
         "plain_gru": ["--net", "gru", "--collect", "plain"],
         "seac_ppo": ["--algo", "seac-ppo"],
         "seac_ppo_msg": ["--algo", "seac-ppo", "--msg-bits", "2"],
         "seac": ["--algo", "seac"]}


def argv(name, tmp, updates, *extra):
    return ["--device", "cpu", "--distributed", "--mesh", "--n-envs", "32", "--rollout-len",
            "4", "--updates", str(updates), "--log-every", "1", "--checkpoint-dir",
            os.path.join(tmp, name), *CASES[name], *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp_placed_train"))
    tasks = []
    for name in CASES:
        tasks += [{"kind": "train", "name": f"{name}_first", "argv": argv(name, tmp, 1)},
                  {"kind": "train", "name": f"{name}_resumed",
                   "argv": argv(name, tmp, 2, "--resume")}]
    procs = torch_dp_worker.spawn(tasks, 2, tmp)
    return tmp, torch_dp_worker.results(procs, tasks, tmp)


@pytest.mark.parametrize("name", CASES)
def test_train_mesh_runs_the_placement_learners(runs, name):
    tmp, out = runs
    first, resumed = out[f"{name}_first"], out[f"{name}_resumed"]
    for r in range(2):
        assert "sharded 32 envs over 2 processes" in first[r]["printed"]
        assert "resumed from update 1" in resumed[r]["printed"]
    assert "saved" in first[0]["printed"] and "saved" not in first[1]["printed"]
    directory = os.path.join(tmp, name)
    assert torch.load(os.path.join(directory, "policy.pt"), weights_only=False)["updates"] == 2
    runner_dir = os.path.join(directory, "runner")
    assert sorted(os.listdir(runner_dir)) == sorted(
        f"{s}.rank{r}-of2.pt" for s in (1, 2) for r in (0, 1))
    for step in (1, 2):
        shards = [torch.load(os.path.join(runner_dir, f"{step}.rank{r}-of2.pt"),
                             weights_only=True) for r in (0, 1)]
        assert all(s["update_idx"] == step for s in shards)
        assert digest(pack(shards[0]["params"])) == digest(pack(shards[1]["params"]))
        assert digest(shards[0]["env_states"]) != digest(shards[1]["env_states"])
    entry = resumed[0]["entry"]
    assert entry and all(v == v for v in entry.values())  # the log's numbers are finite
