"""Checkpoint / resume and the metric logger of the port
(``rware_tpu_torch.checkpoint``, ``rware_tpu_torch.metrics.MetricLogger``), on
the CPU: what ``tests/test_checkpoint.py`` and ``tests/test_metrics.py`` check
of the JAX package's checkpointer and logger, that ``train`` logs through the
logger, and that a resumed run
equals an unbroken one bit for bit: three updates in one go against two
updates, a save, a restore into a runner and a train step built afresh, and
one more update — for the plain IPPO learner and recurrent SEAC-PPO, and
through ``train --checkpoint-every --resume``.
"""
import numpy as np
import pytest
import torch

import rware_tpu_torch
from rware_tpu_torch import train
from rware_tpu_torch.checkpoint import Checkpointer, pack, unpack
from rware_tpu_torch.metrics import MetricLogger
from rware_tpu_torch.models import ippo, seac

torch.set_num_threads(1)


def assert_runners_equal(a, b):
    """Every tensor, scalar and generator state of two runners equal."""
    pa, pb = pack(a), pack(b)

    def walk(x, y, path):
        if isinstance(x, dict):
            assert x.keys() == y.keys(), path
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
        elif isinstance(x, list):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}[{i}]")
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path
    walk(pa, pb, "runner")


def test_pack_unpack_roundtrip():
    gen = torch.Generator().manual_seed(7)
    torch.rand(3, generator=gen)
    tree = {"gen": gen, "x": torch.arange(3), "empty": torch.zeros((4, 0)),
            "nested": {"h": torch.ones(2, dtype=torch.bfloat16), "n": 5}, "pair": (1, 2.5)}
    packed = pack(tree)
    assert isinstance(packed["gen"], dict) and isinstance(packed["pair"], list)
    template = {"gen": torch.Generator(), "x": torch.zeros(3, dtype=torch.int64),
                "empty": torch.ones((4, 0)), "nested": {"h": torch.zeros(2), "n": 0},
                "pair": (0, 0.0)}
    back = unpack(packed, template)
    assert torch.equal(back["x"], tree["x"]) and back["empty"].shape == (4, 0)
    assert back["nested"]["h"].dtype == torch.bfloat16 and back["nested"]["n"] == 5
    assert back["pair"] == (1, 2.5)
    assert torch.equal(torch.rand(4, generator=back["gen"]), torch.rand(4, generator=gen))


def test_restore_latest_and_missing(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    assert ckpt.latest_step is None
    ckpt = Checkpointer(str(tmp_path / "kept"), max_to_keep=2)
    for step in (1, 2, 3):
        ckpt.save(step, {"step": torch.tensor(step)})
    assert ckpt.steps() == [2, 3] and ckpt.latest_step == 3
    assert int(ckpt.restore()["step"]) == 3 and int(ckpt.restore(2)["step"]) == 2


def _resume_equals_unbroken(tmp_path, build):
    """``build() -> (runner, train_step)`` from scratch; three updates in one
    go against two, a save, a restore into a new runner and step, and one."""
    runner, step = build()
    runner, _ = step(runner)
    runner, _ = step(runner)
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(2, runner)
    template, step2 = build()
    restored = ckpt.restore(template=template)
    assert restored.update_idx == 2
    assert_runners_equal(restored, runner)
    cont, m3 = step(runner)
    again, n3 = step2(restored)
    assert_runners_equal(again, cont)
    for k in m3:
        assert torch.equal(m3[k], n3[k]), k
    return cont


def test_resume_equals_unbroken_ippo(tmp_path):
    """The plain IPPO learner: parameters, Adam moments, env states and the
    minibatch generator continue as if unbroken."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu", max_steps=10)
    cfg = ippo.IPPOConfig(n_envs=8, rollout_len=8, epochs=1, minibatches=2)

    def build():
        runner, dims = ippo.init_runner(env, cfg, seed=0, hidden=(16, 16))
        return runner, ippo.build_train_step(env, dims, cfg)

    cont = _resume_equals_unbroken(tmp_path, build)
    assert cont.update_idx == 3 and cont.opt_state.count == 6


def test_resume_equals_unbroken_recurrent_seac(tmp_path):
    """Recurrent SEAC-PPO with message bits: the (N, P) stack, its moments,
    env states with messages, the carry and the generator."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu", max_steps=5, msg_bits=1)
    cfg = seac.SEACPPOConfig(n_envs=8, rollout_len=4, epochs=2, minibatches=2)

    def build():
        runner, dims = seac.init_seac_gru(env, cfg, seed=0, hidden=16, embed=16)
        return runner, seac.build_seac_gru_train_step(env, dims, cfg)

    cont = _resume_equals_unbroken(tmp_path, build)
    assert cont.update_idx == 3 and float(cont.carry.float().abs().max()) > 0


def test_train_resume_equals_unbroken(tmp_path):
    """``train --checkpoint-every 1`` for two updates, then ``--resume`` to
    three: the same policy as three updates in one run."""
    base = ["--device", "cpu", "--n-envs", "16", "--rollout-len", "4", "--log-every", "1",
            "--checkpoint-every", "1"]
    train.main(base + ["--updates", "3", "--checkpoint-dir", str(tmp_path / "a")])
    train.main(base + ["--updates", "2", "--checkpoint-dir", str(tmp_path / "b")])
    ckpt = Checkpointer(str(tmp_path / "b" / "runner"))
    assert ckpt.steps() == [1, 2]
    out = train.main(base + ["--updates", "3", "--checkpoint-dir", str(tmp_path / "b"),
                             "--resume"])
    assert np.isfinite(out["pg_loss"]) and ckpt.latest_step == 3
    want = torch.load(str(tmp_path / "a" / "policy.pt"))["state_dict"]
    got = torch.load(str(tmp_path / "b" / "policy.pt"))["state_dict"]
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_train_logs_through_the_metric_logger(capsys):
    """``train`` prints one logger line per logged window (every
    ``--log-every`` updates and the last) and returns the last entry."""
    out = train.main(["--device", "cpu", "--n-envs", "8", "--rollout-len", "4", "--updates",
                      "3", "--log-every", "2"])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("step ")]
    assert [l.split()[1] for l in lines] == ["2", "3"]
    assert all("env_steps_per_s=" in l and "wall_s=" in l for l in lines)
    assert out["step"] == 3 and out["env_steps_per_s"] > 0 and np.isfinite(out["pg_loss"])


def test_metric_logger_accumulates():
    logger = MetricLogger(print_every=0)
    for step in range(1, 4):
        entry = logger.log(step, {"loss": torch.tensor(0.5 * step)}, env_steps=100)
        assert entry["step"] == step and "env_steps_per_s" in entry
    assert abs(logger.summary()["loss"] - 1.0) < 1e-6
    assert len(logger.history) == 3
