"""The port's ``VectorGymWarehouse`` against the JAX package's
(``tests/test_vector.py``): the gym.vector contract and NEXT_STEP autoreset.

Both vector envs run from the same batched state (JAX's, injected into the
port) under the same actions: observations of every type, rewards,
terminated, truncated and ``info`` must be equal.  An env that resets draws
its state from another generator in each package, so a reset env is checked
by rule (reward 0, not terminated, info zeroed, a fresh valid state) and
JAX's states are carried on; queue resamples likewise.
"""
import gymnasium as gym
import numpy as np
import pytest
import torch

import rware_tpu.vector as jax_vector
import rware_tpu_torch
import rware_tpu_torch.gym_adapter as port_gym
import rware_tpu_torch.vector as port_vector
from rware_tpu_torch import debug
from rware_tpu_torch.core.host import convert_obs_batch, to_host
from rware_tpu_torch.types import ObservationType
from tests.torch_gym_ref import assert_tree_equal, restore_registry
from tests.torch_ref import DYNAMICS_FIELDS, check_queue_rule, to_port

torch.set_num_threads(1)

B = 4


def sample_actions(venv, rng):
    return tuple(
        rng.integers(0, 5, size=B).astype(np.int64)
        for _ in range(venv.config.n_agents)
    )


def vec_pair(env_id="rware-tiny-2ag-v2", num_envs=B, seed=0, **overrides):
    """(JAX vector env, port vector env on the CPU), both reset, the port
    holding JAX's states."""
    jv = jax_vector.make_vec(env_id, num_envs=num_envs, **overrides)
    pv = port_vector.make_vec(env_id, num_envs=num_envs, device="cpu", **overrides)
    jobs, _ = jv.reset(seed=seed)
    pv.reset(seed=seed)
    pv._host.states = to_port(jv.states)
    return jv, pv, jobs


def observe_host(pv):
    obs = pv._env.observe(pv.states)
    if isinstance(obs, dict):
        obs = dict(zip(obs, to_host(*obs.values())))
    else:
        obs = to_host(obs)[0]
    return convert_obs_batch(pv.config, obs)


def vstep_pair(jv, pv, actions):
    """One step of both: the envs that stepped equal field by field, the
    envs that reset checked by rule, every output equal; then JAX's states
    are carried on."""
    prev_done = to_host(pv._host.prev_done)[0]
    np.testing.assert_array_equal(prev_done, np.asarray(jv._prev_done))
    q_before = np.asarray(jv.states.request_queue)
    jout = jv.step(actions)
    pout = pv.step(actions)
    for got, want in zip(pout[1:], jout[1:]):
        assert_tree_equal(got, want, "step output")
    stepped = ~prev_done
    port = {f: to_host(getattr(pv.states, f))[0] for f in DYNAMICS_FIELDS}
    for f in DYNAMICS_FIELDS:
        np.testing.assert_array_equal(port[f][stepped], np.asarray(getattr(jv.states, f))[stepped],
                                      err_msg=f)
    q_port = to_host(pv.states.request_queue)[0]
    q_jax = np.asarray(jv.states.request_queue)
    check_queue_rule(q_before[stepped], q_jax[stepped], q_port[stepped], pv.config.n_shelves)
    if prev_done.any():
        assert (port["cur_steps"][prev_done] == 0).all()
        assert debug.state_invariant_errors(pv.states, pv.config) == []
    if (q_port == q_jax).all() and not prev_done.any():
        assert_tree_equal(pout[0], jout[0])
    pv._host.states = to_port(jv.states)
    assert_tree_equal(observe_host(pv), jout[0])
    return pout


def test_vector_contract_flattened():
    jv, pv, jobs = vec_pair()
    assert isinstance(pv, gym.vector.VectorEnv)
    assert pv.num_envs == B
    assert pv.observation_space == jv.observation_space
    assert pv.action_space == jv.action_space
    assert_tree_equal(observe_host(pv), jobs)
    assert pv.observation_space.contains(jobs)
    rng = np.random.default_rng(1)
    for _ in range(3):
        obs, rew, term, trunc, info = vstep_pair(jv, pv, sample_actions(pv, rng))
        assert pv.observation_space.contains(obs)
        assert rew.shape == (B, pv.config.n_agents) and rew.dtype == np.float32
        assert term.shape == (B,) and trunc.shape == (B,)
        assert not trunc.any()
        assert {"deliveries", "failed_moves"} <= set(info)


def test_vector_action_space_layouts():
    jv, pv, _ = vec_pair()
    # batched-space tuple layout
    a = pv.action_space.sample()
    vstep_pair(jv, pv, a)
    # raw (B, N) array layout
    arr = np.stack([np.asarray(x) for x in a], axis=1)
    assert torch.equal(pv._convert_actions(arr), pv._convert_actions(a))
    obs2, *_ = vstep_pair(jv, pv, arr)
    assert pv.observation_space.contains(obs2)
    with pytest.raises(ValueError):
        port_vector.make_vec("rware-tiny-2ag-v2", num_envs=B, device="cpu",
                             msg_bits=2)._convert_actions(arr)


@pytest.mark.parametrize("obs_type,msg_bits", [
    (ObservationType.DICT, 2), (ObservationType.IMAGE, 0), (ObservationType.IMAGE_DICT, 2),
    (ObservationType.FLATTENED, 1)], ids=lambda v: getattr(v, "name", str(v)))
def test_vector_obs_types(obs_type, msg_bits):
    jv, pv, jobs = vec_pair(seed=3, observation_type=obs_type, msg_bits=msg_bits)
    assert pv.observation_space == jv.observation_space
    assert pv.action_space == jv.action_space
    assert_tree_equal(observe_host(pv), jobs)
    assert pv.observation_space.contains(jobs)
    pv.action_space.seed(int(obs_type) + msg_bits)
    for _ in range(2):
        obs, *_ = vstep_pair(jv, pv, pv.action_space.sample())
    assert pv.observation_space.contains(obs)
    if obs_type == ObservationType.IMAGE_DICT:
        assert len(obs) == pv.config.n_agents
        assert obs[0]["image"].shape[0] == B
        assert obs[0]["features"].shape == (B, 6)


def test_flat_to_dict_batch_matches_jax():
    jv = jax_vector.make_vec("rware-2s-tiny-2ag-v2", num_envs=B, msg_bits=3)
    pv = port_vector.make_vec("rware-2s-tiny-2ag-v2", num_envs=B, device="cpu", msg_bits=3)
    rng = np.random.default_rng(0)
    flat = rng.integers(0, 2, size=(7, pv.config.flattened_obs_length)).astype(np.float32)
    flat[:, :2] = rng.integers(0, 9, size=(7, 2))
    assert_tree_equal(pv._flat_to_dict_batch(flat), jv._flat_to_dict_batch(flat))


def test_vector_next_step_autoreset():
    """From a state one step before every episode's end: the step that ends
    them, then the step that resets them on the device, against JAX's."""
    jv, pv, _ = vec_pair(max_steps=3)
    rng = np.random.default_rng(2)
    for t in range(2):
        vstep_pair(jv, pv, sample_actions(pv, rng))
    obs, rew, term, trunc, info = vstep_pair(jv, pv, sample_actions(pv, rng))
    # horizon hit: every env reports terminated on step 3...
    assert term.all()
    assert int(to_host(pv.states.cur_steps)[0][0]) == 3
    # ...and the NEXT step resets on the device instead of stepping
    obs, rew, term, trunc, info = vstep_pair(jv, pv, sample_actions(pv, rng))
    assert not term.any()
    assert (rew == 0).all()
    assert (np.asarray(info["failed_moves"]) == 0).all()
    # and the episode then proceeds normally
    vstep_pair(jv, pv, sample_actions(pv, rng))
    assert (to_host(pv.states.cur_steps)[0] == 1).all()


def test_vector_autoreset_mixed_batch():
    """Only the envs that ended reset; the others step on."""
    jv, pv, _ = vec_pair(max_steps=5)
    rng = np.random.default_rng(5)
    jv._states = jv.states.replace(cur_steps=jv.states.cur_steps.at[1].set(4))
    pv._host.states = to_port(jv.states)
    for t in range(3):
        _, _, term, *_ = vstep_pair(jv, pv, sample_actions(pv, rng))
        assert term.tolist() == [False, t == 0, False, False]
    assert to_host(pv.states.cur_steps)[0].tolist() == [3, 1, 3, 3]


def test_device_program_is_the_functional_engine():
    """``Warehouse.step_next_autoreset`` on the vector env's generator equals
    ``Warehouse.step`` and a reset from the same generator state, selected
    env by env."""
    pv = port_vector.make_vec("rware-tiny-2ag-v2", num_envs=64, device="cpu", max_steps=4)
    pv.reset(seed=11)
    env = pv._env
    rng = np.random.default_rng(0)
    for t in range(9):
        state, prev = pv.states, pv._host.prev_done.clone()
        gen = torch.Generator().set_state(pv._host.generator.get_state())
        actions = rng.integers(0, 5, size=(64, 2))
        obs, rew, term, trunc, info = pv.step(actions)
        res = env.step(state, torch.from_numpy(actions.astype(np.int32)), gen)
        fresh = env.reset_state(gen, 64)
        want = fresh.where(prev, res.state)
        for f in DYNAMICS_FIELDS + ("request_queue",):
            assert torch.equal(getattr(pv.states, f), getattr(want, f)), (t, f)
        keep = ~prev.numpy()
        np.testing.assert_array_equal(rew, np.where(keep[:, None], res.rewards.numpy(), 0))
        np.testing.assert_array_equal(term, res.done.numpy() & keep)
        for k in info:
            np.testing.assert_array_equal(info[k], np.where(keep, res.info[k].numpy(), 0))
        want_obs = torch.where(prev[:, None, None], env.observe(fresh), res.obs).numpy()
        np.testing.assert_array_equal(np.stack(obs, axis=1), want_obs)
    assert to_host(pv._host.prev_done)[0].any() or term.any()


def test_gym_make_vec_entry_point():
    port_gym.register_all(force=True)
    venv = gym.make_vec("rware-tiny-2ag-v2", num_envs=B, device="cpu")
    assert isinstance(venv, port_vector.VectorGymWarehouse)
    obs, _ = venv.reset(seed=0)
    obs, rew, term, trunc, info = venv.step(venv.action_space.sample())
    assert venv.observation_space.contains(obs)
    assert rew.shape == (B, venv.config.n_agents)
    venv = gym.make_vec("rware-tiny-2ag-v2", num_envs=2, device="cpu", max_steps=9)
    assert venv.config.max_steps == 9 and venv.num_envs == 2


def test_vector_reset_determinism():
    v1 = rware_tpu_torch.make_vec("rware-tiny-2ag-v2", num_envs=B, device="cpu")
    v2 = rware_tpu_torch.make_vec("rware-tiny-2ag-v2", num_envs=B, device="cpu")
    o1, _ = v1.reset(seed=7)
    o2, _ = v2.reset(seed=7)
    for a, b in zip(o1, o2):
        np.testing.assert_array_equal(a, b)
    # different envs in the batch start in different states
    assert not np.array_equal(o1[0][0], o1[0][1])
    a = v1.action_space.sample()
    for x, y in zip(v1.step(a)[0], v2.step(a)[0]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("obs_type", [ObservationType.FLATTENED, ObservationType.IMAGE_DICT],
                         ids=lambda t: t.name)
def test_vector_seed_list_equals_single_envs(obs_type):
    """Env i of ``reset(seed=[..., s_i, ...])`` is a one-env
    ``GymWarehouse.reset(seed=s_i)`` on the same device."""
    seeds = [5, 123, 5, 2**31 - 2]
    pv = port_vector.make_vec("rware-small-4ag-v2", num_envs=len(seeds), device="cpu",
                              observation_type=obs_type)
    obs, _ = pv.reset(seed=seeds)
    single = port_gym.make_gym("rware-small-4ag-v2", device="cpu", observation_type=obs_type)
    for i, s in enumerate(seeds):
        sobs, _ = single.reset(seed=s)
        for f in DYNAMICS_FIELDS + ("request_queue",):
            assert torch.equal(getattr(pv.states, f)[i:i + 1], getattr(single.state, f)), f
        per_env = tuple(
            {k: v[i] for k, v in o.items()} if isinstance(o, dict) else o[i] for o in obs)
        assert_tree_equal(per_env, sobs)
    assert_tree_equal(tuple(o[0] for o in obs if not isinstance(o, dict)),
                      tuple(o[2] for o in obs if not isinstance(o, dict)))
    with pytest.raises(ValueError):
        pv.reset(seed=[1, 2])


def test_vector_render_env0():
    from rware_tpu.rendering import Viewer as JaxViewer

    jv, pv, _ = vec_pair()
    state0 = type(jv.states)(**{f: getattr(jv.states, f)[0]
                                for f in jv.states.__dataclass_fields__})
    assert pv.render().tobytes() == JaxViewer(jv.config).frame(state0).tobytes()


def test_to_host_packs_every_dtype():
    ts = [torch.arange(6, dtype=torch.float32).reshape(2, 3), torch.tensor([True, False, True]),
          torch.zeros((2, 0, 3)), torch.tensor([-3, 7], dtype=torch.int32),
          torch.tensor(5, dtype=torch.int64), torch.tensor([[1, 2, 3]], dtype=torch.uint8)]
    for got, t in zip(to_host(*ts), ts):
        want = t.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
@pytest.mark.parametrize("entry", ["VectorGymWarehouse", "make_vec", "top_level",
                                   "vector_entry_point", "gym.make_vec"])
def test_entry_points_default_to_the_card(entry):
    port_gym.register_all(force=True)
    calls = {
        "VectorGymWarehouse": lambda: port_vector.VectorGymWarehouse("rware-tiny-2ag-v2", 4),
        "make_vec": lambda: port_vector.make_vec("rware-tiny-2ag-v2", num_envs=4),
        "top_level": lambda: rware_tpu_torch.make_vec("rware-tiny-2ag-v2", num_envs=4),
        "vector_entry_point": lambda: port_vector.vector_entry_point(4, "rware-tiny-2ag-v2"),
        "gym.make_vec": lambda: gym.make_vec("rware-tiny-2ag-v2", num_envs=4),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
