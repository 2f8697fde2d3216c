"""Image observations of the port against the JAX package, bit for bit: the
global layer stack, the windows (``build_image_obs_fn``), the IMAGE_DICT
features, the learners' flat view (``policy_obs_fn``), ``global_image`` and
``step_autoreset``'s per-leaf select.

The values are small integers (0/1, AGENT_DIRECTION 1-4), so every
comparison is exact: no tolerance.  States come from scripted scenarios
(``rware_tpu.testing.make_state``: agents on the grid's corners and edges at
all four headings, carrying and not, a requested shelf and a goal in the
window) and from random resets walked a few random steps.  Tiny's grid is
11 x 10, so a transposed layer would show.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.models import ippo as jax_ippo
from rware_tpu.testing import make_state as jax_make_state
from rware_tpu.types import ImageLayer as JaxLayer
from rware_tpu_torch.models import ippo
from rware_tpu_torch.parallel import batched_reset
from rware_tpu_torch.types import DEFAULT_GLOBAL_IMAGE_LAYERS, ObservationType
from tests.torch_ref import cpu_generator, jax_states, make_pair, to_port

torch.set_num_threads(1)

# every layer, in an order other than the enum's
ALL_LAYERS = tuple(JaxLayer(k) for k in (6, 3, 0, 4, 1, 5, 2))
CONFIGS = ["rware-img-tiny-2ag-v2", "rware-imgdict-tiny-2ag-v2", "rware-img-Nd-tiny-2ag-v2",
           "rware-img-2s-tiny-2ag-v2", "all-seven-layers"]


def _config(name):
    if name == "all-seven-layers":
        return dataclasses.replace(rware_tpu.parse_env_id("rware-imgdict-tiny-2ag-v2"),
                                   image_observation_layers=ALL_LAYERS)
    return rware_tpu.parse_env_id(name)


def _scenarios(config):
    """A batch of scripted two-agent states: agent 0 on each corner and edge
    cell at each heading, carrying on odd headings; agent 1 beside a goal or
    on a shelf's slot; the shelf beside agent 0's cell requested where there
    is one."""
    layout = config.compile_layout()
    h, w = layout.grid_size
    slots = [tuple(int(v) for v in s) for s in layout.shelf_slots]
    gx, gy = (int(v) for v in layout.goals[0])
    cells = [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1), (w // 2, 0), (0, h // 2),
             (w - 1, h // 2), (w // 2, h - 1), slots[0], (gx, gy - 1)]
    partners = [(gx + 1, gy), slots[5], (gx, gy)]
    states = []
    for k, (x, y) in enumerate(cells):
        for d in range(4):
            other = next(p for p in partners[k % 3:] + partners if p != (x, y))
            near = [s for s, (sx, sy) in enumerate(slots) if abs(sx - x) + abs(sy - y) == 1]
            queue = list(range(config.request_queue_size))
            if near:
                queue[0] = near[0]
                queue[1:] = [q for q in range(len(slots)) if q != near[0]][: len(queue) - 1]
            carrying = [7 if d % 2 else -1, 9 if d >= 2 else -1]
            states.append(jax_make_state(config, [(x, y, d), other + (3 - d,)],
                                         queue=queue, carrying=carrying))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def _walked(jenv, n_envs=96, n_steps=8, seed=3):
    """Random resets walked ``n_steps`` biased random steps (agents pick up
    and carry shelves)."""
    states = jax_states(jenv, n_envs, seed=seed)
    rng = np.random.default_rng(seed)
    step = jax.jit(jax.vmap(jenv._step_fn))
    for _ in range(n_steps):
        acts = rng.choice(5, size=(n_envs, jenv.config.n_agents), p=[0.1, 0.4, 0.2, 0.1, 0.2])
        states = step(states, jnp.asarray(acts, dtype=jnp.int32)).state
    return states


def _assert_obs_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_obs_equal(got[k], want[k])
        return
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module", params=CONFIGS)
def pair_states(request):
    jenv, env = make_pair(_config(request.param))
    scripted = _scenarios(jenv.config)
    walked = _walked(jenv)
    return request.param, jenv, env, (scripted, walked)


@pytest.mark.parametrize("which", ["scripted", "walked"])
def test_image_obs_bit_exact(pair_states, which):
    name, jenv, env, states = pair_states
    jstates = states[which == "walked"]
    want = jax.vmap(jenv._obs_fn)(jstates)
    got = env.observe(to_port(jstates))
    _assert_obs_equal(got, want)
    image = got["image"] if isinstance(got, dict) else got
    c, side = len(env.config.image_observation_layers), env.config.window_size
    assert tuple(image.shape[1:]) == (env.n_agents, c, side, side)
    if which == "scripted":  # the scenarios put shelves, requests and goals in view
        for layer in (JaxLayer.SHELVES, JaxLayer.REQUESTS, JaxLayer.GOALS):
            if layer in env.config.image_observation_layers:
                k = env.config.image_observation_layers.index(layer)
                assert float(image[:, :, k].sum()) > 0, layer


@pytest.mark.parametrize("which", ["scripted", "walked"])
def test_policy_obs_bit_exact(pair_states, which):
    name, jenv, env, states = pair_states
    jstates = states[which == "walked"]
    want = jax.vmap(jax_ippo.policy_obs_fn(jenv))(jstates)
    got = ippo.policy_obs_fn(env)(to_port(jstates))
    assert tuple(got.shape) == (want.shape[0], env.n_agents, env.config.policy_obs_length)
    _assert_obs_equal(got, want)


def test_global_image_bit_exact(pair_states):
    name, jenv, env, (scripted, walked) = pair_states
    for jstates in (scripted, walked):
        want = jax.vmap(jenv.global_image)(jstates)
        got = env.global_image(to_port(jstates))
        h, w = env.grid_size
        assert tuple(got.shape) == (want.shape[0], len(DEFAULT_GLOBAL_IMAGE_LAYERS), h, w)
        _assert_obs_equal(got, want)


@pytest.mark.parametrize("layers", [ALL_LAYERS, ALL_LAYERS[::-1]])
def test_global_layers_of_every_layer(layers):
    from rware_tpu.core.observations import build_global_layers_fn as jax_layers
    from rware_tpu_torch.core.observations import build_global_layers_fn

    jenv, env = make_pair(_config("all-seven-layers"))
    jstates = _walked(jenv, n_envs=32, n_steps=12, seed=5)
    want = jax.vmap(jax_layers(jenv.config, layers))(jstates)
    got = build_global_layers_fn(env.config, tuple(int(k) for k in layers))(to_port(jstates))
    _assert_obs_equal(got, want)
    direction = layers.index(JaxLayer.AGENT_DIRECTION)
    assert set(np.unique(got[:, direction].numpy())) <= {0.0, 1.0, 2.0, 3.0, 4.0}


@pytest.mark.parametrize("env_id", ["rware-img-tiny-2ag-v2", "rware-imgdict-tiny-2ag-v2",
                                    "rware-img-Nd-tiny-2ag-v2"])
def test_make_reset_step_autoreset(env_id):
    """``make`` builds the env; reset, step and ``step_autoreset`` give the
    observation of the state they return, leaf by leaf, fresh where an
    episode ended; where none ended and nothing was delivered (so no queue
    slot was redrawn from another generator) the observations equal JAX's
    ``step_autoreset``'s."""
    jenv = rware_tpu.make(env_id, max_steps=3)
    env = rware_tpu_torch.make(env_id, max_steps=3, device="cpu")
    n = 64
    jstates = _walked(jenv, n_envs=n, n_steps=1, seed=7)  # cur_steps 1
    jstates = jstates.replace(cur_steps=jnp.arange(n, dtype=jnp.int32) % 3)
    acts = np.random.default_rng(1).integers(0, 5, (n, 2)).astype(np.int32)
    jres = jax.vmap(jenv.step_autoreset)(jstates, jnp.asarray(acts))
    res = env.step_autoreset(to_port(jstates), torch.from_numpy(acts), cpu_generator(0))
    done = res.done.numpy()
    assert done.tolist() == (np.arange(n) % 3 == 2).tolist()
    np.testing.assert_array_equal(done, np.asarray(jres.done))
    _assert_obs_equal(res.obs, jax.tree.map(np.asarray, env.observe(res.state)))
    keep = ~done & (res.info["deliveries"].numpy() == 0)
    assert keep.sum() > n // 2
    want = jax.tree.map(lambda x: np.asarray(x)[keep], jres.obs)
    got = jax.tree.map(lambda x: x[torch.from_numpy(keep)], res.obs)
    _assert_obs_equal(got, want)
    states, obs = env.reset(cpu_generator(1), 5)
    _assert_obs_equal(obs, jax.tree.map(np.asarray, env.observe(states)))
    if env.config.observation_type == ObservationType.IMAGE_DICT:
        assert set(obs) == {"image", "features"} and tuple(obs["features"].shape) == (5, 2, 6)
    step = env.step(states, env.sample_actions(cpu_generator(2), 5), cpu_generator(3))
    _assert_obs_equal(step.obs, jax.tree.map(np.asarray, env.observe(step.state)))


def test_batched_reset_and_runner_obs_are_policy_obs():
    """``batched_reset`` returns the env's own observations (the 5-D windows);
    the learners' runners hold the flat policy view, as JAX's do."""
    env = rware_tpu_torch.make("rware-imgdict-tiny-2ag-v2", device="cpu")
    states, obs = batched_reset(env, 0, 8)
    assert tuple(obs["image"].shape) == (8, 2, 5, 3, 3)
    runner, dims = ippo.init_runner(env, ippo.IPPOConfig(n_envs=8), 0)
    assert dims.obs_len == env.config.policy_obs_length == 51
    np.testing.assert_array_equal(runner.obs.numpy(), ippo.policy_obs_fn(env)(states).numpy())
