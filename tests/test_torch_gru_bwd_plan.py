"""K10's launch plan (``rware_tpu_torch/ops/fused_gru.py::gru_obs_bwd_plan``)
on the CPU: the numbers the wrapper hands to ``csrc/fused_gru_bwd.cu``.

For every observation length the registry's ids give (flattened, image and
image-dict observations, directional or not, sensor ranges 1-5, and the
flattened ones with two message bits), for embed and hidden widths (128, 128),
(24, 40) (multiples of 8 but not of 16: the tensor-core tiles are padded) and
(8, 8), for 2 and 16 agents and for bands from 1 env to 4,096:

- the sweep's tiles, the prologue's and epilogue's tiles and the
  weight-gradient chunks each cover their band's sequences or samples exactly
  once;
- no kernel asks for more shared memory than one block may take on the H100
  (232,448 bytes);
- the scratch holds T n_env N samples;
- the sweep takes the smallest tile height whose blocks fit the card's 132
  SMs in one wave.

Widths the kernels do not take raise the wrapper's ``ValueError``.
"""
import dataclasses

import pytest
import torch

from rware_tpu_torch.models.networks import GruDims
from rware_tpu_torch.ops.fused_gru import SMEM_MAX, SWEEP_SMS, gru_obs_bwd_plan
from rware_tpu_torch.registry import parse_env_id

torch.set_num_threads(1)

WIDTHS = [(128, 128), (24, 40), (8, 8)]
AGENTS = [2, 16]
BANDS = [1, 7, 640, 2048, 4096]
T_LENS = [128, 3]


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


def _plans(widths, n_agents):
    e, hg = widths
    for length in OBS_LENGTHS:
        for n_env in BANDS:
            for t_len in T_LENS:
                yield (t_len, n_env), gru_obs_bwd_plan(GruDims(length, e, hg, 5), t_len, n_agents,
                                                       n_env)


def _covers_once(ranges, n):
    """``ranges`` are non-empty, each starts where the one before stopped, the
    first at 0 and the last stops at ``n``: every index once."""
    if not ranges or ranges[0].start != 0 or ranges[-1].stop != n:
        return False
    return all(r.step == 1 and len(r) > 0 for r in ranges) and all(
        a.stop == b.start for a, b in zip(ranges, ranges[1:]))


def test_the_registry_gives_many_obs_lengths():
    assert 71 in OBS_LENGTHS and len(OBS_LENGTHS) >= 10 and max(OBS_LENGTHS) > 512


@pytest.mark.parametrize("n_agents", AGENTS)
@pytest.mark.parametrize("widths", WIDTHS)
def test_tiles_cover_each_sequence_once(widths, n_agents):
    for (t_len, n_env), plan in _plans(widths, n_agents):
        assert plan.n_seq == n_env * n_agents and plan.n_samples == t_len * plan.n_seq
        assert _covers_once(plan.sweep_tiles(), plan.n_seq), (widths, t_len, n_env)
        assert _covers_once(plan.sample_tiles(), plan.n_samples)
        assert _covers_once(plan.chunks(), plan.n_samples)
        assert plan.chunk % 64 == 0 and plan.n_chunks <= 128


@pytest.mark.parametrize("n_agents", AGENTS)
@pytest.mark.parametrize("widths", WIDTHS)
def test_no_kernel_asks_for_more_shared_memory_than_a_block_has(widths, n_agents):
    assert SMEM_MAX == 232_448
    for _, plan in _plans(widths, n_agents):
        assert set(plan.smem) == {"prologue", "sweep", "epilogue", "wgrad"}
        assert all(0 < b <= SMEM_MAX for b in plan.smem.values()), plan.smem


@pytest.mark.parametrize("n_agents", AGENTS)
@pytest.mark.parametrize("widths", WIDTHS)
def test_the_scratch_holds_every_sample(widths, n_agents):
    e, hg = widths
    per_sample = {"e": (e, torch.bfloat16), "rz": (2 * hg, torch.float32),
                  "hn": (2 * hg, torch.bfloat16), "dg4": (4 * hg, torch.bfloat16),
                  "dpre": (e, torch.bfloat16)}
    for _, plan in _plans(widths, n_agents):
        for name, (width, dtype) in per_sample.items():
            assert plan.scratch[name] == ((plan.n_samples, width), dtype), name
        assert plan.scratch["part_bhn"] == ((plan.sweep_blocks, hg), torch.float32)
        n_w = plan.scratch["partial"][0][1]
        assert plan.scratch["partial"][0] == (plan.n_chunks, n_w)
        # the weight blocks before dbhn: (L + 1) E + (E + 1) 3Hg + Hg 3Hg
        assert (n_w - (e + 1) * 3 * hg - hg * 3 * hg) % e == 0


@pytest.mark.parametrize("n_agents", AGENTS)
def test_the_sweep_fills_the_card_in_one_wave(n_agents):
    for n_env in BANDS + [64, 8192]:
        plan = gru_obs_bwd_plan(GruDims(71, 128, 128, 5), 128, n_agents, n_env)
        n_seq = n_env * n_agents
        if n_seq <= 64 * SWEEP_SMS:
            assert plan.sweep_blocks <= SWEEP_SMS
            smaller = plan.sweep_rows // 2
            assert plan.sweep_rows == 16 or -(-n_seq // smaller) > SWEEP_SMS
        else:
            assert plan.sweep_rows == 64
    # the main shape: a 4,096-env band of tiny-2ag; the learning runs: 1,024 envs
    assert gru_obs_bwd_plan(GruDims(71, 128, 128, 5), 128, 2, 4096).sweep_rows == 64
    assert gru_obs_bwd_plan(GruDims(71, 128, 128, 5), 128, 2, 1024).sweep_rows == 16


@pytest.mark.parametrize("widths", [(128, 256), (12, 128), (128, 20), (136, 8)])
def test_refuses_widths_the_kernels_do_not_take(widths):
    with pytest.raises(ValueError, match="multiples of 8 up to 128"):
        gru_obs_bwd_plan(GruDims(71, widths[0], widths[1], 5), 128, 2, 4096)
