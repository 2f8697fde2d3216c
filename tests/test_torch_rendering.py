"""The port's renderer and human play against the JAX package's
(``tests/test_gym_adapter.py``'s renderer cases, ``tests/test_human_play.py``):
frames equal byte for byte on the same states, the same key maps."""
import os
import sys

import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu_torch.core.host import to_host
from tests.torch_gym_ref import pair, reset_pair, restore_registry, step_pair
from tests.torch_ref import to_port

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- renderer ----------------------------------------------------------------


def test_render_rgb_array():
    jenv, penv = pair(render_mode="rgb_array")
    reset_pair(jenv, penv)
    frame = penv.render()
    assert frame.shape == (11 * 30 + 1, 10 * 30 + 1, 3)
    assert frame.dtype == np.uint8
    # agents drawn: some orange pixels
    orange = (frame == np.array([255, 165, 0], np.uint8)).all(-1)
    assert orange.sum() > 100
    assert frame.tobytes() == jenv.render().tobytes()
    # every heading, loaded agents and requested shelves, frame by frame
    for actions in ([1, 1], [2, 3], [2, 3], [4, 4], [1, 1], [3, 2], [1, 4]):
        step_pair(jenv, penv, actions)
        frame2 = penv.render()
        assert frame2.shape == frame.shape
        assert frame2.tobytes() == jenv.render().tobytes()
    penv.close()


def test_render_frame_of_any_env_of_a_batch():
    from rware_tpu.rendering import Viewer as JaxViewer
    from rware_tpu_torch.rendering import Viewer
    from tests.torch_ref import jax_states

    jenv = rware_tpu.make("rware-small-4ag-v2")
    jstates = jax_states(jenv, 3, seed=2)
    port = Viewer(rware_tpu_torch.parse_env_id("rware-small-4ag-v2"))
    states = to_port(jstates)
    for b in range(3):
        want = JaxViewer(jenv.config).frame(
            type(jstates)(**{f: getattr(jstates, f)[b] for f in jstates.__dataclass_fields__}))
        assert port.frame(states, b).tobytes() == want.tobytes()


def test_interactive_viewer_headless_raises():
    """InteractiveViewer declines cleanly under a headless Agg backend so
    human_play falls back to curses."""
    import matplotlib

    matplotlib.use("Agg")
    from rware_tpu_torch.rendering import InteractiveViewer

    with pytest.raises(RuntimeError):
        InteractiveViewer(rware_tpu_torch.WarehouseConfig())


# --- human play (tests/test_human_play.py) ------------------------------------

KEYS = ["up", "down", "left", "right", "tab", "escape", " ", "p", "l", "h", "d", "r", "q",
        "w", "a", "s", "x"]


@pytest.mark.parametrize("mode", ["reference", "friendly"])
def test_human_play_key_maps_match(mode):
    sys.path.insert(0, REPO)
    import human_play as jax_play
    from rware_tpu_torch import human_play

    for key in KEYS:
        for heading in range(4):
            assert human_play.dispatch_key(mode, key, heading) == \
                jax_play.dispatch_key(mode, key, heading), (mode, key, heading)
    assert human_play.HELP_REFERENCE == jax_play.HELP_REFERENCE
    assert human_play.HELP_FRIENDLY == jax_play.HELP_FRIENDLY


def test_human_play_window_plays_through_the_port(monkeypatch):
    """The windowed loop with a stand-in viewer: keys dispatch to the
    selected agent's actions on the port's env."""
    from rware_tpu_torch import human_play, rendering

    viewers, shown = [], []

    class FakeViewer:
        open = False  # the loop ends at once; the keys are pressed below

        def __init__(self, config):
            self.on_key_press = None
            viewers.append(self)

        def show(self, state, env=0):
            shown.append(to_host(state.agent_dir[0])[0].tolist())

        def close(self):
            pass

    monkeypatch.setattr(rendering, "InteractiveViewer", FakeViewer)
    args = human_play.parse_args(["--device", "cpu", "--seed", "3"])
    env = human_play.make_env(args)
    assert human_play.main_window(args, env)
    start = shown[-1]
    for key in ("left", "tab", "right", "x"):
        viewers[0].on_key_press(key)
    rot_left, rot_right = [2, 3, 1, 0], [3, 2, 0, 1]
    assert shown[-1] == [rot_left[start[0]], rot_right[start[1]]]
