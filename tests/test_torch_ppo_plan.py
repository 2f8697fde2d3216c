"""The PPO kernels' launch plan (``rware_tpu_torch/ops/fused_update.py::ppo_plan``)
on the CPU: the numbers the K3-K8 wrappers hand to ``csrc/fused_ppo_grads.cu``
and the files beside it.

For every observation length the registry's ids give (flattened, image and
image-dict observations, directional or not, sensor ranges 1-5, and the
flattened ones with two message bits), for the central critic's joint lengths
at 2 to 16 agents, and for hidden widths (128, 128), (64, 64) and (36, 20)
(multiples of 4 but not of 16: the tensor-core tiles are padded):

- the per-sample kernel's tiles and the weight-gradient chunks each cover the
  window's samples exactly once, and through the window's rows (which wrap
  past the end of the trajectory) its trajectory rows exactly once;
- no kernel asks for more shared memory than one block may take on the H100
  (232,448 bytes);
- the scratch holds every sample's rows at 16-byte strides.

Widths the kernels do not take raise the wrappers' ``ValueError``.
"""
import dataclasses

import pytest
import torch

from rware_tpu_torch.models.networks import BlockDims, CriticDims
from rware_tpu_torch.ops.fused_mappo import (
    build_fused_critic_values,
    build_fused_mappo_grads,
    critic_plan,
)
from rware_tpu_torch.ops.fused_seac import build_fused_seac_grads
from rware_tpu_torch.ops.fused_update import (
    SMEM_LIMIT,
    build_fused_ppo_grads,
    build_fused_ppo_update_phase,
    ppo_plan,
    sample_smem,
    wgrad_smem,
)
from rware_tpu_torch.registry import parse_env_id

torch.set_num_threads(1)

WIDTHS = [(128, 128), (64, 64), (36, 20)]
# (T_mb, B, N) windows: the main shape, the smoke's B=1000, and ragged ones
WINDOWS = [(32, 16384, 2), (4, 1000, 2), (2, 1000, 16), (3, 7, 1)]
KW = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01)


def _obs_lengths():
    lengths = set()
    for sensor in ("", "-2s", "-3s", "-4s", "-5s"):
        for kind in ("", "-img", "-imgdict", "-img-Nd", "-imgdict-Nd"):
            cfg = parse_env_id(f"rware{kind}{sensor}-tiny-2ag-v2")
            lengths.add(cfg.policy_obs_length)
            if not kind:
                lengths.add(dataclasses.replace(cfg, msg_bits=2).policy_obs_length)
    return sorted(lengths)


OBS_LENGTHS = _obs_lengths()
JOINT_LENGTHS = sorted({n * parse_env_id(f"rware-tiny-{n}ag-v2").policy_obs_length
                        for n in range(2, 17)})


def _actor_plans(widths):
    h1, h2 = widths
    for length in OBS_LENGTHS:
        for hc, heads in ((8, 6), (16, 8)):  # K4, and K4 with two message bits
            for t_mb, b, n in WINDOWS:
                yield (t_mb, b, n), ppo_plan(length, h1, h2, heads, hc, t_mb * b * n)


def _critic_plans(widths):
    h1, h2 = widths
    for joint in JOINT_LENGTHS:
        n = joint // 71
        for t_mb, b, _ in WINDOWS:
            cdims = CriticDims(n, 71, h1, h2)
            yield (t_mb, b, 1), critic_plan(cdims, t_mb * b)
            yield (t_mb, b, 1), critic_plan(cdims, t_mb * b, backward=False)


def _covers_once(ranges, n):
    """``ranges`` are non-empty, each starts where the one before stopped, the
    first at 0 and the last stops at ``n``: every index once."""
    if not ranges or ranges[0].start != 0 or ranges[-1].stop != n:
        return False
    return all(r.step == 1 and len(r) > 0 for r in ranges) and all(
        a.stop == b.start for a, b in zip(ranges, ranges[1:]))


def _window_row(start, t_full, bn, s):
    """``ppo_row`` of ``csrc/ppo_core.cuh``: the trajectory row of sample s."""
    t = s // bn
    return ((start + t) % t_full) * bn + (s - t * bn)


def test_the_registry_gives_many_lengths():
    assert 71 in OBS_LENGTHS and len(OBS_LENGTHS) >= 10 and max(OBS_LENGTHS) > 512
    assert JOINT_LENGTHS[0] == 142 and JOINT_LENGTHS[-1] == 16 * 71


@pytest.mark.parametrize("widths", WIDTHS)
def test_tiles_and_chunks_cover_each_sample_once(widths):
    plans = list(_actor_plans(widths)) + list(_critic_plans(widths))
    for (t_mb, b, n), plan in plans:
        s = t_mb * b * n
        assert plan.n_samples == s and plan.tile == 64
        tiles = sorted((r for block in plan.block_tiles() for r in block), key=lambda r: r.start)
        assert _covers_once(tiles, s), (widths, t_mb, b, n)
        assert all(block for block in plan.block_tiles())  # no idle block
        if plan.chunk:
            assert _covers_once(plan.chunks(), s)
            assert plan.chunk % 64 == 0 and plan.n_chunks <= 128


@pytest.mark.parametrize("start", [0, 5, 7])
def test_the_tiles_reach_each_row_of_a_wrapping_window_once(start):
    t_full, t_mb, b, n = 8, 3, 37, 2  # starts 6 and 7 wrap past the trajectory's end
    plan = ppo_plan(71, 36, 20, 6, 8, t_mb * b * n)
    rows = [_window_row(start, t_full, b * n, s)
            for block in plan.block_tiles() for tile in block for s in tile]
    want = {((start + t) % t_full) * b * n + q for t in range(t_mb) for q in range(b * n)}
    assert len(rows) == len(set(rows)) and set(rows) == want


@pytest.mark.parametrize("widths", WIDTHS)
def test_no_kernel_asks_for_more_shared_memory_than_a_block_has(widths):
    assert SMEM_LIMIT == 232_448
    for _, plan in list(_actor_plans(widths)) + list(_critic_plans(widths)):
        assert 0 < plan.smem["sample"] <= SMEM_LIMIT, plan.smem
        if plan.chunk:
            assert plan.smem["wgrad"] == wgrad_smem() <= SMEM_LIMIT
        assert plan.args()[2] == plan.smem["sample"]
    # dense_0 leaves shared memory only where it does not fit there
    for length in OBS_LENGTHS + JOINT_LENGTHS:
        resident = sample_smem(length, *widths, 6, 8, 64, True) <= SMEM_LIMIT
        assert ppo_plan(length, *widths, 6, 8, 4096).w0_smem == resident


def test_the_main_shape_runs_two_blocks_an_sm_with_dense0_resident():
    plan = ppo_plan(71, 128, 128, 6, 8, 32 * 16384 * 2)
    assert plan.w0_smem and plan.grid == 2 * 132 and plan.n_chunks == 128
    assert critic_plan(CriticDims(2, 71, 128, 128), 32 * 16384).grid == 2 * 132
    # sensor range 4 keeps dense_0 resident, sensor range 5 streams it
    assert ppo_plan(575, 128, 128, 6, 8, 1024).w0_smem
    assert not ppo_plan(855, 128, 128, 6, 8, 1024).w0_smem


@pytest.mark.parametrize("widths", WIDTHS)
def test_the_scratch_holds_every_sample(widths):
    h1, h2 = widths
    r8 = lambda x: -(-x // 8) * 8  # noqa: E731
    for (t_mb, b, n), plan in _actor_plans(widths):
        s, bf = t_mb * b * n, torch.bfloat16
        assert plan.scratch["h1"] == ((s, r8(h1)), bf) == plan.scratch["dz1"]
        assert plan.scratch["h2"] == ((s, r8(h2)), bf) == plan.scratch["dz2"]
        assert plan.scratch["part_mets"] == ((plan.grid, 4), torch.float32)
        heads = plan.scratch["part_head"][0][1] // (h2 + 1)
        assert plan.scratch["part_head"][0] == (plan.grid, (h2 + 1) * heads)
        assert list(plan.scratch) == ["h1", "h2", "dz1", "dz2", "part_head", "partial",
                                      "part_mets"]
    for _, plan in _critic_plans(widths):
        assert plan.scratch == {} or plan.scratch["partial"][0][0] == plan.n_chunks


@pytest.mark.parametrize("widths", [(128, 256), (132, 128), (128, 6), (0, 128), (256, 256)])
def test_refuses_widths_the_kernels_do_not_take(widths):
    h1, h2 = widths
    with pytest.raises(ValueError, match="multiples of 4 up to 128"):
        ppo_plan(71, h1, h2, 6, 8, 1024)
    dims = BlockDims(71, h1, h2, 5)
    cdims = CriticDims(2, 71, h1, h2)
    for build in (lambda: build_fused_ppo_grads(dims, 4, **KW),
                  lambda: build_fused_ppo_update_phase(dims, 16, 4, 4, max_grad_norm=0.5, **KW),
                  lambda: build_fused_mappo_grads(BlockDims(71, 128, 128, 5), cdims, 4, **KW),
                  lambda: build_fused_critic_values(cdims),
                  lambda: build_fused_seac_grads(dims, 2, 4, seac_lambda=1.0, **KW)):
        with pytest.raises(ValueError, match="multiples of 4 up to 128"):
            build()
