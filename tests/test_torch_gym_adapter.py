"""The port's Gymnasium adapter, wrappers and spaces against the JAX
package's (``tests/test_gym_adapter.py``; the renderer and human play are in
``tests/test_torch_rendering.py``).

Each case runs both packages' classes from the same state (a JAX reset
injected into the port) under the same actions: observations of every type,
rewards, done, truncated, ``info``, the spaces, the wrappers' outputs,
``get_global_image`` and the rendered frames must be equal.  Queue resamples
come from different generators, so a step that resamples is checked by rule
and JAX's queue is carried on.  No test leaves ``gym.registry`` changed.
"""
import dataclasses

import gymnasium as gym
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu.gym_adapter as jax_gym
import rware_tpu.utils.wrappers as jax_wrappers
import rware_tpu_torch
import rware_tpu_torch.gym_adapter as port_gym
import rware_tpu_torch.utils.wrappers as port_wrappers
from rware_tpu_torch import ObservationType, RewardType
from rware_tpu_torch.core.host import to_host
from tests.torch_gym_ref import assert_tree_equal, pair, reset_pair, restore_registry, step_pair
from tests.torch_ref import to_port

torch.set_num_threads(1)

OBS_TYPES = [ObservationType.FLATTENED, ObservationType.DICT, ObservationType.IMAGE,
             ObservationType.IMAGE_DICT]


def test_basic_episode_contract():
    jenv, penv = pair()
    jobs, pobs = reset_pair(jenv, penv)
    assert_tree_equal(pobs, jobs)
    assert isinstance(pobs, tuple) and len(pobs) == 2
    assert penv.observation_space.contains(pobs)
    jenv.action_space.seed(0)
    for _ in range(20):
        _, _, rewards, done, truncated, info = step_pair(jenv, penv, list(jenv.action_space.sample()))
        assert len(rewards) == 2 and isinstance(rewards[0], float)
        assert truncated is False
    penv.close()


@pytest.mark.parametrize("msg_bits", [0, 2])
@pytest.mark.parametrize("obs_type", OBS_TYPES, ids=lambda t: t.name)
def test_obs_space_containment_all_types(obs_type, msg_bits):
    jenv, penv = pair(observation_type=obs_type, msg_bits=msg_bits)
    assert penv.observation_space == jenv.observation_space
    assert penv.action_space == jenv.action_space
    jobs, pobs = reset_pair(jenv, penv, seed=1)
    assert_tree_equal(pobs, jobs)
    jenv.action_space.seed(obs_type * 10 + msg_bits)
    for _ in range(10):
        _, obs, *_ = step_pair(jenv, penv, list(jenv.action_space.sample()))
    assert penv.observation_space.contains(obs), obs_type


def test_dict_flattens_to_flattened():
    # flatten(DICT) == FLATTENED bit for bit (reference tests/test_env.py:406-512)
    dict_env = port_gym.make_gym("rware-tiny-2ag-v2", device="cpu",
                                 observation_type=ObservationType.DICT)
    flat_env = port_gym.make_gym("rware-tiny-2ag-v2", device="cpu",
                                 observation_type=ObservationType.FLATTENED)
    dict_obs, _ = dict_env.reset(seed=5)
    flat_env.state = dict_env.state  # identical underlying state
    flat_obs = flat_env._convert_obs(flat_env._env.observe(flat_env.state))
    jenv = jax_gym.make_gym("rware-tiny-2ag-v2", observation_type=ObservationType.DICT)
    jenv.reset(seed=5)
    for i in range(2):
        flat_from_dict = gym.spaces.flatten(dict_env.observation_space[i], dict_obs[i])
        np.testing.assert_array_equal(flat_from_dict, flat_obs[i])
        # the same state in JAX's adapter gives the same dict
        jenv.state = jenv.state.replace(**{
            f: np.asarray(getattr(dict_env.state, f)[0])
            for f in ("agent_x", "agent_y", "agent_dir", "shelf_x", "shelf_y",
                      "request_queue", "agent_carrying")})
        jdict = jenv._convert_obs(jenv._env.observe(jenv.state))
        assert_tree_equal(dict_obs, jdict)


def test_action_space_msg_bits():
    cfg = rware_tpu.WarehouseConfig(n_agents=2, msg_bits=2, request_queue_size=2)
    jenv, penv = pair(cfg)
    sa = penv.action_space[0]
    assert isinstance(sa, gym.spaces.MultiDiscrete)
    assert sa.nvec.tolist() == [5, 2, 2]
    assert penv.action_space == jenv.action_space
    reset_pair(jenv, penv)
    step_pair(jenv, penv, [np.array([1, 0, 1]), np.array([0, 1, 0])])
    assert to_host(penv.state.agent_message[0])[0].tolist() == [[0.0, 1.0], [1.0, 0.0]]


def test_seed_reproducibility():
    env = port_gym.make_gym("rware-tiny-2ag-v2", device="cpu")
    a, _ = env.reset(seed=42)
    b, _ = env.reset(seed=42)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c, _ = env.reset(seed=43)
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))
    # the legacy seed() applies to the next reset only
    env.seed(42)
    d, _ = env.reset()
    e, _ = env.reset()
    assert all(np.array_equal(x, y) for x, y in zip(a, d))
    assert any(not np.array_equal(x, y) for x, y in zip(a, e))


def test_state_injection_roundtrip():
    jenv, penv = pair()
    reset_pair(jenv, penv)
    penv.state = penv.state.set_agent(0, x=3, y=4)
    jenv.state = jenv.state.set_agent(0, x=3, y=4)
    assert to_host(penv.state.agent_x)[0][0, 0] == 3
    step_pair(jenv, penv, [0, 0])
    assert to_host(penv.state.agent_x)[0][0, 0] == 3  # NOOP kept position
    assert penv.request_queue == np.asarray(jenv.state.request_queue).tolist()
    assert penv.goals == jenv.goals
    np.testing.assert_array_equal(penv.highways, jenv.highways)
    assert penv.grid_size == jenv.grid_size and penv.n_agents == jenv.n_agents


@pytest.mark.parametrize("layers", [None, (rware_tpu.ImageLayer.AGENTS,
                                           rware_tpu.ImageLayer.AGENT_DIRECTION,
                                           rware_tpu.ImageLayer.REQUESTS)])
def test_get_global_image(layers):
    jenv, penv = pair()
    reset_pair(jenv, penv)
    for _ in range(2):
        step_pair(jenv, penv, [1, 4])
    kw = {} if layers is None else {"image_layers": layers}
    img = penv.get_global_image(**kw)
    want = jenv.get_global_image(**kw)
    assert img.dtype == want.dtype
    np.testing.assert_array_equal(img, want)
    if layers is None:
        assert img.shape == (2, 11, 10)  # (C=2 default layers, H, W)
        assert set(np.unique(img)) <= {0.0, 1.0}
    c = img.shape[0]
    padded = penv.get_global_image(pad_to_shape=(c, 15, 14), recompute=True, **kw)
    np.testing.assert_array_equal(
        padded, jenv.get_global_image(pad_to_shape=(c, 15, 14), recompute=True, **kw))
    assert padded.shape == (c, 15, 14)
    np.testing.assert_array_equal(padded[:, 2:13, 2:12], img)
    with pytest.raises(ValueError):
        penv.get_global_image(pad_to_shape=(c, 5, 5), recompute=True, **kw)


def test_register_all_registers_grid():
    for env_id in [k for k in gym.registry if k.startswith("rware")]:
        del gym.registry[env_id]
    n = port_gym.register_all()
    assert n == 4 * 19 * 3
    assert gym.spec("rware-tiny-2ag-v2").entry_point == port_gym.ENTRY_POINT
    env = gym.make("rware-tiny-2ag-v2", device="cpu", disable_env_checker=True)
    assert isinstance(env.unwrapped, port_gym.GymWarehouse)
    assert env.unwrapped.device.type == "cpu"
    obs, info = env.reset(seed=0)
    assert len(obs) == 2
    assert port_gym.register_all() == 0  # idempotent
    # ids another package registered keep their entry points
    jax_gym.register_all(force=True)
    assert port_gym.register_all() == 0
    assert gym.spec("rware-tiny-2ag-v2").entry_point == "rware_tpu.gym_adapter:GymWarehouse"


def test_register_all_top_level_export():
    rware_tpu_torch.register_all(image=True, force=True)
    env = gym.make("rware-img-tiny-2ag-v2", device="cpu", disable_env_checker=True)
    jenv = jax_gym.make_gym("rware-img-tiny-2ag-v2")
    obs, info = env.reset(seed=0)
    assert obs[0].shape[0] == 5  # image layers, directional window
    assert env.observation_space == jenv.observation_space


def test_gym_make_passes_the_device_and_overrides():
    port_gym.register_all(force=True)
    env = gym.make("rware-tiny-2ag-v2", device="cpu", max_steps=7)  # env checker on
    assert env.unwrapped.config.max_steps == 7
    env.reset(seed=0)
    for _ in range(7):
        *_, done, _, _ = env.step(env.action_space.sample())
    assert done


# --- wrappers (reference: rware/utils/wrappers.py, tests/test_wrappers.py) ---


def test_flatten_agents():
    jenv, penv = pair()
    reset_pair(jenv, penv)
    jw, pw = jax_wrappers.FlattenAgents(jenv), port_wrappers.FlattenAgents(penv)
    assert pw.action_space == jw.action_space
    assert pw.observation_space == jw.observation_space
    assert isinstance(pw.action_space, gym.spaces.MultiDiscrete)
    jw.action_space.seed(3)
    for _ in range(5):
        a = jw.action_space.sample()
        jout, pout = jw.step(a), pw.step(a)
        penv.state = penv.state.replace(
            request_queue=torch.from_numpy(np.array(jenv.state.request_queue))[None])
        assert pout[0].shape == (2 * 71,)
        assert isinstance(pout[1], float)
        assert_tree_equal(pout[1:], jout[1:])
        if pout[4]["deliveries"] == 0:
            np.testing.assert_array_equal(pout[0], jout[0])
    obs, _ = pw.reset(seed=0)
    assert obs.shape == (2 * 71,)


def test_dict_agents():
    jenv, penv = pair()
    reset_pair(jenv, penv)
    jw, pw = jax_wrappers.DictAgents(jenv), port_wrappers.DictAgents(penv)
    actions = {"agent_0": 1, "agent_1": 0}
    jout, pout = jw.step(actions), pw.step(actions)
    assert set(pout[1]) == {"agent_0", "agent_1"} and set(pout[2]) == {"agent_0", "agent_1"}
    assert_tree_equal(pout, jout)
    obs, info = pw.reset(seed=0)
    assert set(obs.keys()) == {"agent_0", "agent_1"}


def test_flatten_sa_observation():
    jenv, penv = pair(observation_type=ObservationType.DICT)
    jw, pw = (jax_wrappers.FlattenSAObservation(jenv),
              port_wrappers.FlattenSAObservation(penv))
    assert pw.observation_space == jw.observation_space
    jobs, _ = jw.reset(seed=0)
    pw.reset(seed=0)
    penv.state = to_port(jenv.state, batched=False)
    pobs, *_ = pw.step([0, 0])
    jobs, *_ = jw.step([0, 0])
    assert len(pobs) == 2 and pobs[0].shape == (71,)
    assert_tree_equal(pobs, jobs)


def test_flatten_agents_msg_bits_action():
    """FlattenAgents splits joint actions into (1+msg_bits)-wide slices
    (reference np.split semantics, rware/utils/wrappers.py:33)."""
    args = (3, 8, 1, 2, 2, 1, 2, None, 500, RewardType.INDIVIDUAL)
    jw = jax_wrappers.FlattenAgents(jax_gym.GymWarehouse(*args))
    pw = port_wrappers.FlattenAgents(port_gym.GymWarehouse(*args, device="cpu"))
    assert pw.action_space == jw.action_space
    jw.reset(seed=0)
    pw.reset(seed=0)
    pw.unwrapped.state = to_port(jw.unwrapped.state, batched=False)
    joint = np.array([1, 0, 1, 1, 1, 0], dtype=np.int64)  # 2 agents x (action + 2 bits)
    jout, pout = jw.step(joint), pw.step(joint)
    assert np.isscalar(pout[1]) or np.ndim(pout[1]) == 0
    assert_tree_equal(pout, jout)


def test_register_full_variants():
    port_gym.register_full(sensor_ranges=[3], column_heights=[12], force=True)
    env = gym.make("rware-3s-tiny-2ag-v2", device="cpu", disable_env_checker=True)
    obs, _ = env.reset(seed=0)
    assert obs[0].shape == (8 + 49 * 7,)
    env2 = gym.make("rware-small-12h-4ag-easy-v2", device="cpu", disable_env_checker=True)
    assert env2.unwrapped.grid_size == (28, 10)
    assert env.unwrapped.observation_space == jax_gym.make_gym("rware-3s-tiny-2ag-v2").observation_space


def test_reference_positional_extras():
    """Positionals 11+ (layout, observation_type, ...) map like the
    reference signature (rware/warehouse.py:146-170); overflow raises."""
    args = (3, 8, 1, 2, 0, 1, 2, None, 500, RewardType.INDIVIDUAL, None, ObservationType.DICT)
    env = port_gym.GymWarehouse(*args, device="cpu")
    assert env.config.observation_type == ObservationType.DICT
    assert dataclasses.asdict(env.config) == dataclasses.asdict(jax_gym.GymWarehouse(*args).config)
    with pytest.raises(TypeError):
        port_gym.GymWarehouse(*args, None, True, False, None, 99, device="cpu")
    # env_id with kwargs overriding the id's config
    env = port_gym.GymWarehouse(env_id="rware-small-4ag-v2", max_steps=9, device="cpu")
    assert env.config.max_steps == 9 and env.config.n_agents == 4
    with pytest.raises(TypeError):
        port_gym.GymWarehouse(env.config, max_steps=9, device="cpu")


# --- the device: the card unless asked ----------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
@pytest.mark.parametrize("entry", ["GymWarehouse", "make_gym", "top_level", "gym.make",
                                   "human_play"])
def test_entry_points_default_to_the_card(entry):
    from rware_tpu_torch import human_play

    port_gym.register_all(force=True)
    calls = {
        "GymWarehouse": lambda: port_gym.GymWarehouse(env_id="rware-tiny-2ag-v2"),
        "make_gym": lambda: port_gym.make_gym("rware-tiny-2ag-v2"),
        "top_level": lambda: rware_tpu_torch.make_gym("rware-tiny-2ag-v2"),
        "gym.make": lambda: gym.make("rware-tiny-2ag-v2"),
        "human_play": lambda: human_play.run(["--env", "rware-tiny-2ag-v2"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
