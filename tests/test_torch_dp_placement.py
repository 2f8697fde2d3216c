"""The learners JAX only places on a device mesh (``train.py:291-303``), data
parallel in the port with the whole batch's statistics, on the CPU: two
ranks of the in-process emulation (``testing.emulate_mesh``) against one
rank of the same global batch (a world-1 mesh, which equals the learner
without one bit for bit).

The five cases of ``testing.DP_PLACED`` at tiny-2ag, hidden 32, B=128, T=8,
E=2, M=2, one update: plain IPPO (shuffled minibatches), plain recurrent
IPPO, SEAC-PPO on K8 (its plain version here), SEAC-PPO's flat learner with
two message bits, SEAC A2C (T=8).

* Each rank's trajectory is its rows of the global collect, bit for bit.
* The first pass's gradients before Adam (the output of the pass's packed
  float32 all-reduce) lie within 1e-4 of each block's largest magnitude of
  the one-rank gradients.
* The whole update: parameters within 0.05 * lr * P (P the optimizer steps
  of an update), rtol 1e-3; metrics within rtol 1e-2, atol 1e-4.
* Negative control: the rule of the learners JAX builds with ``mesh=``
  (each shard's own statistics and means, the shard means averaged) misses
  the first-pass check by at least 10 times its bound in every case with a
  statistic.  SEAC A2C's loss takes none and its ranks' rollouts are equal,
  so there the two rules agree.
* Uneven splits: minibatches that lie wholly in one rank's envs (handed-in
  permutations, or SEAC's flat rows with B / 2 rows a minibatch) give the
  one-rank gradients, the other rank joining each pass with none.
"""
import numpy as np
import pytest
import torch

import rware_tpu_torch
from rware_tpu_torch.models.ippo import IPPOConfig
from rware_tpu_torch.parallel.sharding import Mesh, rank_rows
from rware_tpu_torch.testing import DP_PLACED, dp_config, dp_learner, dp_run, emulate_mesh

torch.set_num_threads(1)

ENV = "rware-tiny-2ag-v2"
B, T_LEN, EPOCHS, MINIBATCHES, HIDDEN, SEED = 128, 8, 2, 2, 32, 7
GRAD_FRAC = 1e-4  # of each block's largest one-rank gradient
CONTROL_MISS = 10  # times the bound the per-shard rule must miss by
WITH_STATS = tuple(n for n in DP_PLACED if n != "seac_a2c")


def make_env(name):
    overrides = {"max_steps": 6}  # episodes end inside the update
    if name == "seac_flat":
        overrides["msg_bits"] = 2
    return rware_tpu_torch.make(ENV, device="cpu", **overrides)


def run(name, mesh, per_shard=False, windows=None, **fields):
    """One update of learner ``name`` on this rank of ``mesh`` (:func:`dp_run`)
    and the first pass's (gradients, metrics) as the ranks' all-reduce gave
    them.  ``per_shard`` keeps every statistic the shard's own (no float64
    all-reduce) and averages the passes' shard means instead of summing."""
    first = []
    if per_shard:
        mesh.psum = lambda tree: tree
        mesh.all_reduce_sum = mesh.all_reduce_mean
    for attr in ("all_reduce_sum", "all_reduce_mean"):
        def record(tree, reduce=getattr(mesh, attr)):
            out = reduce(tree)
            first.append(out)
            return out

        setattr(mesh, attr, record)
    cfg = dp_config(name, **{**dict(n_envs=B, rollout_len=T_LEN, epochs=EPOCHS,
                                    minibatches=MINIBATCHES), **fields})
    runner, step = dp_learner(name, make_env(name), cfg, SEED, mesh, hidden=HIDDEN)
    out = dp_run(step, runner, 1, mesh, windows)
    out.update(first=first[0], dims=step.dims,
               steps=getattr(cfg, "epochs", 1) * getattr(cfg, "minibatches", 1))
    return out


def blocks(dims, grads):
    """The parameter blocks of a flat gradient or of each row of an (N, P) stack."""
    return [blk for row in (grads if grads.dim() == 2 else grads[None]) for blk in dims.split(row)]


def worst_miss(dims, got, want):
    """The largest ratio, over the blocks, of the gradient's error to its bound
    (GRAD_FRAC of the block's largest one-rank magnitude)."""
    worst = 0.0
    for g, w in zip(blocks(dims, got), blocks(dims, want)):
        err, bound = float((g - w).abs().max()), GRAD_FRAC * float(w.abs().max())
        worst = max(worst, err / bound if bound > 0 else (0.0 if err == 0 else float("inf")))
    return worst


_CASES = {}


def case(name):
    """(one rank, the two ranks, the two ranks by the per-shard rule) of a case."""
    if name not in _CASES:
        one = emulate_mesh(lambda mesh: run(name, mesh), 1, timeout=120)[0]
        two = emulate_mesh(lambda mesh: run(name, mesh), 2, timeout=120)
        shard = emulate_mesh(lambda mesh: run(name, mesh, per_shard=True), 2, timeout=120) \
            if name in WITH_STATS else None
        _CASES[name] = (one, two, shard)
    return _CASES[name]


def check_update(one, two):
    """The ranks' update against the one-rank update, the ranks' parameters equal."""
    tol = 0.05 * IPPOConfig().lr * one["steps"]
    for out in two:
        np.testing.assert_allclose(out["runner"].params.numpy(), one["runner"].params.numpy(),
                                   atol=tol, rtol=1e-3)
        assert out["runner"].opt_state.count == one["runner"].opt_state.count == one["steps"]
        assert set(out["metrics"][0]) == set(one["metrics"][0])
        for k, v in out["metrics"][0].items():
            np.testing.assert_allclose(v, one["metrics"][0][k], rtol=1e-2, atol=1e-4, err_msg=k)
    assert torch.equal(two[0]["runner"].params, two[1]["runner"].params)


@pytest.mark.parametrize("name", DP_PLACED)
def test_rank_trajectory_is_its_rows_of_the_global_collect(name):
    one, two, _ = case(name)
    for r, out in enumerate(two):
        for k, v in one["traj"].items():
            assert torch.equal(out["traj"][k], v[:, r * B // 2:(r + 1) * B // 2]), k


@pytest.mark.parametrize("name", DP_PLACED)
def test_first_pass_gradients_match_one_rank(name):
    one, two, _ = case(name)
    for out in two:
        assert worst_miss(one["dims"], out["first"][0], one["first"][0]) <= 1.0
        for k, v in out["first"][1].items():
            np.testing.assert_allclose(float(v), float(one["first"][1][k]), rtol=1e-4,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", DP_PLACED)
def test_update_matches_one_rank(name):
    one, two, _ = case(name)
    check_update(one, two)
    assert all(m["episodes_done"] > 0 for m in two[0]["metrics"])


@pytest.mark.parametrize("name", WITH_STATS)
def test_per_shard_rule_misses_the_first_pass_check(name):
    one, _, shard = case(name)
    assert worst_miss(one["dims"], shard[0]["first"][0], one["first"][0]) >= CONTROL_MISS


def _halves_first(n_rows, n_envs, gen):
    """A permutation of ``n_rows`` global rows whose first half holds rank 0's
    rows (envs below n_envs / 2) and the second rank 1's."""
    rows = torch.arange(n_rows)
    low = (rows % n_envs) < n_envs // 2
    return torch.cat([r[torch.randperm(len(r), generator=gen)] for r in (rows[low], rows[~low])])


@pytest.mark.parametrize("name", ["ippo_plain", "rnn_ippo_plain", "seac_flat"])
def test_uneven_split_gives_the_one_rank_gradient(name):
    gen = torch.Generator().manual_seed(11)
    fields = {}
    if name == "seac_flat":  # B / 2 rows a minibatch, from offset 0: one rank's rows each
        fields = dict(epochs=1, minibatches=2 * T_LEN)
        draws, first = torch.zeros(1, dtype=torch.int64), torch.arange(B // 2)
    else:
        n = T_LEN * B if name == "ippo_plain" else B
        draws = torch.stack([_halves_first(n, B, gen), torch.randperm(n, generator=gen)])
        first = draws[0, :n // 2]
    assert len(rank_rows(first, B, Mesh(None, 1, 2, "cpu"))) == 0  # rank 1 has no rows
    one = emulate_mesh(lambda mesh: run(name, mesh, windows=[draws], **fields), 1,
                       timeout=120)[0]
    two = emulate_mesh(lambda mesh: run(name, mesh, windows=[draws], **fields), 2,
                       timeout=120)
    for out in two:
        assert worst_miss(one["dims"], out["first"][0], one["first"][0]) <= 1.0
    check_update(one, two)
