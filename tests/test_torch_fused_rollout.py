"""The fused rollout kernel's plain version (K1) against the JAX Pallas
kernel, and the Philox stream both the port's kernels draw from.

The JAX kernel runs as its own tests run it on the CPU: ``interpret=True``
in scripted mode (RNG-free) at B = ENV_BLOCK.  Scripted mode is
deterministic on both sides (lowest-index queue replacement, agent i
respawning at cell i facing UP), so every state field, the reward sums and
the episode counts must match bit for bit.  The CUDA kernel itself runs only
on a GPU (``tests/test_torch_gpu.py``; ``python3 chip_smoke.py`` drives it
at full size).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.ops.pallas_rollout import ENV_BLOCK, build_pallas_rollout
from rware_tpu.testing import DOWN, UP, make_state as jax_make_state
from rware_tpu_torch.ops import philox
from rware_tpu_torch.ops.fused_rollout import (
    build_fused_rollout,
    layout_buffer,
    pack_state,
    unpack_state,
)
from rware_tpu_torch.parallel import batched_reset
from tests.torch_ref import ALL_FIELDS, assert_fields_equal, jax_states, make_pair, to_port

torch.set_num_threads(1)


# --- Philox ----------------------------------------------------------------------

# Random123's known-answer vectors for philox4x32 with 10 rounds.
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    words = philox.philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert [int(w) for w in words] == list(want)


def test_mulhilo_matches_python_ints():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 1000, dtype=np.uint64)
    for m in (philox.M0, philox.M1):
        hi, lo = philox._mulhilo(torch.from_numpy(a.astype(np.int64)), m)
        full = [int(x) * m for x in a]
        assert hi.tolist() == [f >> 32 for f in full]
        assert lo.tolist() == [f & 0xFFFFFFFF for f in full]


def test_uniform_bits_counter_layout():
    seed = (7 << 32) | 12345
    envs = torch.tensor([0, 3, 1000])
    bits = philox.uniform_bits(seed, envs, 9, philox.QUEUE, 6)
    for row, e in enumerate(envs.tolist()):
        for slot in range(6):
            words = philox.philox4x32(
                *(torch.tensor([v]) for v in (e, 9, philox.QUEUE, slot // 4)), 12345, 7
            )
            assert int(bits[row, slot]) == int(words[slot % 4])


def test_draw_formulas():
    bits = philox.uniform_bits(1, torch.arange(20000), 0, philox.RESET, 4)
    assert bool((philox.rand_mod(bits, 5) < 5).all())
    picks = philox.draw_distinct(bits, 6)
    assert bool(((picks >= 0) & (picks < 6)).all())
    assert bool((picks.sort(1).values.diff(1) > 0).all())  # distinct per row
    # every ordered 4-sample of 6 values is equally likely: 360 of them
    codes = ((picks[:, 0] * 6 + picks[:, 1]) * 6 + picks[:, 2]) * 6 + picks[:, 3]
    counts = torch.bincount(codes, minlength=6**4).double()
    counts = counts[counts > 0]
    assert counts.numel() == 360
    expected = 20000 / 360
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert abs(chi2 - 359) / (2 * 359) ** 0.5 < 5, chi2
    zeros = torch.zeros((2, 3), dtype=torch.int64)
    assert philox.draw_distinct(zeros, 10).tolist() == [[0, 1, 2]] * 2
    u = philox.gumbel_uniform(bits)
    assert float(u.min()) >= 0 and float(u.max()) < 1


# --- K1 plain vs the Pallas kernel (scripted, interpret mode) ------------------


def _pallas_vs_plain(env_id_or_config, t_len, actions=None, states=None, seed=1):
    jenv, env = make_pair(env_id_or_config)
    if states is None:
        states = jax_states(jenv, ENV_BLOCK, seed=0)
    if actions is None:
        rng = np.random.default_rng(seed)
        actions = rng.integers(0, 5, (t_len, ENV_BLOCK, env.n_agents)).astype(np.int32)
    roll = build_pallas_rollout(jenv.config, t_len, scripted=True, interpret=True)
    jstate, jrew, jepis = roll(states, 0, jnp.asarray(actions))
    fused = build_fused_rollout(env.config, t_len, scripted=True)
    state, rew, epis = fused(to_port(states), 0, torch.from_numpy(np.asarray(actions)))
    assert fused.launches == 0  # CPU tensors take the plain version
    assert_fields_equal(state, jstate, ALL_FIELDS)
    np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(epis.numpy(), np.asarray(jepis))
    return state, rew, epis


@pytest.mark.parametrize(
    "env_id,with_toggle",
    [
        ("rware-tiny-2ag-v2", False),
        ("rware-tiny-2ag-v2", True),
        ("rware-small-4ag-v2", True),
        ("rware-medium-6ag-hard-v2", True),
    ],
)
def test_scripted_plain_matches_pallas(env_id, with_toggle):
    rng = np.random.default_rng(1)
    n = rware_tpu.parse_env_id(env_id).n_agents
    actions = rng.integers(0, 5, (12, ENV_BLOCK, n)).astype(np.int32)
    if not with_toggle:
        actions = np.where(actions == 4, 0, actions)
    _pallas_vs_plain(env_id, 12, actions)


def test_scripted_plain_matches_pallas_12_agents_contended():
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 10, (6, ENV_BLOCK, 12))
    actions = np.where(raw < 6, 1, raw - 5).astype(np.int32)  # ~60% FORWARD
    _pallas_vs_plain("rware-tiny-12ag-v2", 6, actions)


def test_scripted_plain_matches_pallas_episode_end_and_zero_queue():
    cfg = rware_tpu.WarehouseConfig(n_agents=2, request_queue_size=2, max_steps=3)
    _, _, epis = _pallas_vs_plain(cfg, 7)
    assert epis.min() == 2  # episodes end at t=3 and t=6
    cfg0 = rware_tpu.WarehouseConfig(n_agents=3, request_queue_size=0, max_steps=4)
    _, rew, epis = _pallas_vs_plain(cfg0, 9)
    assert float(rew.sum()) == 0.0 and int(epis.min()) == 2


def test_scripted_plain_matches_pallas_deliveries():
    """Two agents deliver at both goals in one step (large-8ag, R = 8): goal
    order, the lowest-index replacement, the queue and the rewards must all
    match the Pallas kernel."""
    jenv, _ = make_pair("rware-large-8ag-v2")
    cfg = jenv.config
    (g0x, g0y), (g1x, g1y) = ((int(x), int(y)) for x, y in jenv.layout.goals[:2])
    n = cfg.n_agents
    pos = [(g0x, g0y - 1, DOWN), (g1x, g1y - 1, DOWN)] + [(2 + i, 0, UP) for i in range(n - 2)]
    single = jax_make_state(
        cfg, pos, carrying=[0, 1] + [-1] * (n - 2), queue=list(range(cfg.request_queue_size))
    )
    states = jax.tree.map(lambda x: jnp.broadcast_to(x, (ENV_BLOCK,) + x.shape), single)
    states = states.replace(key=jax.random.split(jax.random.key(0), ENV_BLOCK))
    actions = np.zeros((3, ENV_BLOCK, n), dtype=np.int32)
    actions[0, :, :2] = 1
    actions[1, :, 0] = 4
    state, rew, _ = _pallas_vs_plain(cfg, 3, actions, states=states)
    # each step goal 1's replacement re-requests the shelf goal 0 just
    # delivered (and the next step the other way round): three each
    np.testing.assert_array_equal(rew[0, :2].numpy(), [3.0, 3.0])


# --- the wrapper ---------------------------------------------------------------------


def test_wrapper_routes_cpu_to_plain_and_checks_arguments():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2")
    states, _ = batched_reset(env, 0, 37)
    roll = build_fused_rollout(env.config, 5)
    s1, r1, e1 = roll(states, 3)
    s2, r2, e2 = roll.plain(states, 3)
    assert roll.launches == 0 and torch.equal(r1, r2) and r1.shape == (37, 2)
    assert e1.dtype == torch.int32 and e1.shape == (37,)
    with pytest.raises(ValueError):
        roll(states, 3, torch.zeros((5, 37, 2), dtype=torch.int32))  # random mode
    with pytest.raises(ValueError):
        build_fused_rollout(env.config, 5, scripted=True)(states, 3)  # no actions
    with pytest.raises(ValueError):
        roll(states, -1)
    with pytest.raises(ValueError):
        build_fused_rollout(rware_tpu_torch.parse_env_id("rware-tiny-40ag-v2"), 5)
    other, _ = batched_reset(rware_tpu_torch.make("rware-tiny-4ag-v2"), 0, 37)
    with pytest.raises(ValueError):
        roll(other, 3)  # a state of another config
    with pytest.raises(ValueError):
        roll(states.map(lambda x: x[:0]), 3)  # no envs


def test_pack_unpack_round_trip_and_layout_buffer():
    env = rware_tpu_torch.make("rware-medium-6ag-hard-v2")
    states, _ = batched_reset(env, 4, 9)
    packed = pack_state(states)
    n, s, r = 6, env.layout.n_shelves, env.config.request_queue_size
    assert packed.shape == (5 * n + 2 * s + r + 2, 9) and packed.dtype == torch.int32
    back = unpack_state(packed, states)
    for f in ALL_FIELDS:
        assert torch.equal(getattr(back, f), getattr(states, f)), f
    buf = layout_buffer(env.config, "cpu")
    h, w = env.grid_size
    assert buf.numel() == 2 * s + 2 * env.layout.n_goals + h * w


def test_plain_random_draws_do_not_depend_on_the_batch():
    """Counter-based draws: two envs' streams do not depend on the batch
    they run in, so a sub-batch reproduces its rows of the full batch."""
    env = rware_tpu_torch.make("rware-small-4ag-v2", max_steps=20)
    states, _ = batched_reset(env, 1, 16)
    roll = build_fused_rollout(env.config, 30)
    _, rew, epis = roll(states, 9)
    assert int(epis.min()) == 1
    head = states.map(lambda x: x[:8].clone())
    _, rew8, epis8 = roll(head, 9)
    assert torch.equal(rew8, rew[:8]) and torch.equal(epis8, epis[:8])
