"""The four fused collectors take every long-observation id, on the CPU.

``register_full`` registers ``rware-<S>s-...`` for sensor ranges 2-5 beside the
default 1 (up to 1,097 features a row with two message bits).  For every id of
each prefix and sensor range, at every size and difficulty, 1-19 agents and 0
and 2 message bits, at hidden (128, 128), the MLP collector's plan
(``collect_plan``: K2a with one stack, K2d with N) and the recurrent
collector's (``collect_gru_plan``: K2c, K2d′; batches of 16,384 and 1,024)
exist and pass the kernels' invariants (each plan file's ``check_plan``).

Where a route of the plans before the chunked one admits a case (asked for
explicitly: ``chunk=0``, and for K2a ``weights_global=False``, its only route
before the device-memory one), the plan is that route's, field for field; the
new routes take only what the old ones refused: K2a's weights in device
memory with the whole tile, K2d and K2d′ with the observation tile in chunks.
"""
import dataclasses

import pytest
import torch

from rware_tpu_torch.ops.fused_rollout import collect_gru_plan, collect_plan
from rware_tpu_torch.registry import SIZES, parse_env_id
from tests.test_torch_collect_gru_plan import check_plan as check_gru_plan
from tests.test_torch_collect_plan import check_plan

torch.set_num_threads(1)

HIDDEN = (128, 128)
BATCHES = (16384, 1024)
GRID = [(prefix, sensor) for prefix in ("rware", "rware-img", "rware-imgdict")
        for sensor in range(1, 6)]


def grid_configs(prefix, sensor):
    """The configs of every ``prefix`` id at sensor range ``sensor`` (no
    ``-Ns`` part at 1), every size and difficulty, 1-19 agents, 0 and 2
    message bits."""
    part = "" if sensor == 1 else f"-{sensor}s"
    out = []
    for size in SIZES:
        for n in range(1, 20):
            for diff in ("", "-easy", "-hard"):
                try:
                    cfg = parse_env_id(f"{prefix}{part}-{size}-{n}ag{diff}-v2")
                except ValueError:  # a queue longer than the shelves
                    continue
                assert cfg.sensor_range == sensor
                out += [dataclasses.replace(cfg, msg_bits=m) for m in (0, 2)]
    return out


def _old(plan_fn):
    """``plan_fn()``, or None where it raises."""
    try:
        return plan_fn()
    except ValueError:
        return None


@pytest.mark.parametrize("prefix,sensor", GRID)
def test_every_id_gets_a_plan_from_every_collector(prefix, sensor):
    configs = grid_configs(prefix, sensor)
    assert configs
    for cfg in configs:
        n = cfg.n_agents
        for n_stacks in sorted({1, n}):
            check_plan(collect_plan(cfg, HIDDEN, n_stacks), cfg, HIDDEN, n_stacks)
            for b in BATCHES:
                check_gru_plan(collect_gru_plan(cfg, HIDDEN, n_stacks, b), cfg, HIDDEN, n_stacks)


@pytest.mark.parametrize("prefix,sensor", GRID)
def test_what_an_old_route_admits_keeps_its_plan(prefix, sensor):
    refused = 0
    for cfg in grid_configs(prefix, sensor):
        n = cfg.n_agents
        k2a = collect_plan(cfg, HIDDEN, 1)
        old = _old(lambda: collect_plan(cfg, HIDDEN, 1, weights_global=False, chunk=0))
        assert k2a == old if old else (k2a.weights_global and not k2a.kx), cfg
        refused += old is None
        if n > 1:
            k2d = collect_plan(cfg, HIDDEN, n)
            old = _old(lambda: collect_plan(cfg, HIDDEN, n, chunk=0))
            assert k2d == old if old else k2d.kx > 0, cfg
            refused += old is None
        for n_stacks in sorted({1, n}):
            for b in BATCHES:
                plan = collect_gru_plan(cfg, HIDDEN, n_stacks, b)
                old = _old(lambda: collect_gru_plan(cfg, HIDDEN, n_stacks, b, chunk=0))
                assert plan == old if old else (n_stacks > 1 and plan.kx > 0), cfg
                refused += old is None
    # the old routes took every id up to sensor range 3 and refused some at 5
    assert (refused == 0) if sensor <= 3 else (refused > 0 or sensor == 4)
