"""Dependency-free renderer: warehouse state -> RGB frame (the counterpart
of ``rware_tpu/rendering.py``: the same rasteriser, palette, glyphs and
masks, so a state's frame is the JAX package's frame of that state, byte for
byte).

The reference renders through pyglet/OpenGL (the reference's
``rware/rendering.py``) which needs a display and a GL context.  This renderer keeps
the same visual language — grid lines, grey goals, teal requested / slate
idle shelves, orange agents (red when loaded) with a heading tick — but
rasterises with numpy, so it runs identically on headless hosts, notebooks
and CI.  ``render_mode="human"`` displays via matplotlib when a display
exists and silently no-ops otherwise.  A frame takes the port's batched
``WarehouseState`` and an env index; that env's fields come to the host in
one copy.

Visual parity note: the reference's ``_draw_badge`` (rendering.py:335-369,
numbered agent badges) is dead code — never invoked from ``render()``
(rendering.py:121-137) — so the live visual surface is goals+labels,
shelves, hexagonal agents and heading ticks, all reproduced here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.core.host import env_to_host
from rware_tpu_torch.core.state import WarehouseState

CELL = 30  # px per grid cell, matching the reference's scale (rendering.py:92)

# Palette (RGB), close to the reference's colours (rendering.py:24-39).
BACKGROUND = np.array([255, 255, 255], np.uint8)
GRID_LINE = np.array([0, 0, 0], np.uint8)
GOAL = np.array([96, 96, 96], np.uint8)
SHELF = np.array([101, 115, 126], np.uint8)  # slate
SHELF_REQ = np.array([0, 128, 128], np.uint8)  # teal
SHELF_PADDING = 2
AGENT = np.array([255, 165, 0], np.uint8)  # orange
AGENT_LOADED = np.array([220, 20, 60], np.uint8)  # red
AGENT_DIR_TICK = np.array([0, 0, 0], np.uint8)


def _disc_mask(cell: int, radius_frac: float) -> np.ndarray:
    c = (cell - 1) / 2
    yy, xx = np.mgrid[0:cell, 0:cell]
    return (yy - c) ** 2 + (xx - c) ** 2 <= (radius_frac * cell / 2) ** 2


def _hex_mask(cell: int, radius_frac: float) -> np.ndarray:
    """Convex-polygon mask of the reference's resolution-6 'circle'
    (rendering.py:264-287 draws agents as hexagons: 6 vertices at angles
    2*pi*i/6)."""
    c = (cell - 1) / 2
    r = radius_frac * cell / 2
    angles = 2 * np.pi * np.arange(6) / 6
    vx = r * np.cos(angles) + c
    vy = r * np.sin(angles) + c
    yy, xx = np.mgrid[0:cell, 0:cell]
    mask = np.ones((cell, cell), bool)
    for i in range(6):
        j = (i + 1) % 6
        # inside = left of every edge (counter-clockwise winding)
        cross = (vx[j] - vx[i]) * (yy - vy[i]) - (vy[j] - vy[i]) * (xx - vx[i])
        mask &= cross >= 0
    return mask


# 5x7 "G" glyph, scaled below — the reference labels goal cells with a
# white "G" (rendering.py:239-255)
_G_GLYPH = np.array(
    [
        [0, 1, 1, 1, 0],
        [1, 0, 0, 0, 1],
        [1, 0, 0, 0, 0],
        [1, 0, 1, 1, 1],
        [1, 0, 0, 0, 1],
        [1, 0, 0, 0, 1],
        [0, 1, 1, 1, 0],
    ],
    bool,
)


def _scaled_glyph(glyph: np.ndarray, scale: int) -> np.ndarray:
    return np.kron(glyph, np.ones((scale, scale), bool))


_DISC = _hex_mask(CELL, 0.8)
#: the state fields a frame draws
FRAME_FIELDS = ("shelf_x", "shelf_y", "agent_x", "agent_y", "agent_dir", "agent_carrying",
                "request_queue")
_G = _scaled_glyph(_G_GLYPH, 2)  # 10x14 px in a 30 px cell


class Viewer:
    """Rasterises WarehouseState frames; optional matplotlib display."""

    def __init__(self, config: WarehouseConfig):
        self.config = config
        self.layout = config.compile_layout()
        self._fig = None
        self._img_artist = None
        h, w = self.layout.grid_size
        self._base = self._render_static(h, w)

    # -- static background: grid + goals ---------------------------------------

    def _render_static(self, h: int, w: int) -> np.ndarray:
        img = np.tile(BACKGROUND, (h * CELL + 1, w * CELL + 1, 1))
        gh, gw = _G.shape
        oy, ox = (CELL - gh) // 2, (CELL - gw) // 2
        for gx, gy in self.layout.goals:
            img[
                gy * CELL : (gy + 1) * CELL + 1,
                gx * CELL : (gx + 1) * CELL + 1,
            ] = GOAL
            # white "G" label (reference rendering.py:239-255)
            cellview = img[
                gy * CELL + oy : gy * CELL + oy + gh,
                gx * CELL + ox : gx * CELL + ox + gw,
            ]
            cellview[_G] = BACKGROUND
        img[:: CELL, :, :] = GRID_LINE
        img[:, :: CELL, :] = GRID_LINE
        return img

    # -- dynamic entities -------------------------------------------------------

    def render(
        self, state: WarehouseState, return_rgb_array: bool = False, env: int = 0
    ) -> Optional[np.ndarray]:
        frame = self.frame(state, env)
        if return_rgb_array:
            return frame
        self._display(frame)
        return None

    def frame(self, state: WarehouseState, env: int = 0) -> np.ndarray:
        """(H*30+1, W*30+1, 3) uint8 frame of env ``env`` of the batched state."""
        img = self._base.copy()
        f = env_to_host(state, env, FRAME_FIELDS)
        sx, sy = f["shelf_x"], f["shelf_y"]
        ax, ay = f["agent_x"], f["agent_y"]
        adir, carrying = f["agent_dir"], f["agent_carrying"]
        s = np.arange(len(sx))
        requested = np.isin(s, f["request_queue"])

        p = SHELF_PADDING
        for j in range(len(sx)):
            color = SHELF_REQ if requested[j] else SHELF
            x0, y0 = sx[j] * CELL, sy[j] * CELL
            img[y0 + p : y0 + CELL + 1 - p, x0 + p : x0 + CELL + 1 - p] = color

        for i in range(len(ax)):
            color = AGENT_LOADED if carrying[i] >= 0 else AGENT
            x0, y0 = ax[i] * CELL, ay[i] * CELL
            cellview = img[y0 + 1 : y0 + CELL, x0 + 1 : x0 + CELL]
            cellview[_DISC[: cellview.shape[0], : cellview.shape[1]]] = color
            # heading tick from the centre (UP=0, DOWN=1, LEFT=2, RIGHT=3)
            c = CELL // 2
            half = CELL * 2 // 5
            if adir[i] == 0:
                img[y0 + c - half : y0 + c, x0 + c - 1 : x0 + c + 1] = AGENT_DIR_TICK
            elif adir[i] == 1:
                img[y0 + c : y0 + c + half, x0 + c - 1 : x0 + c + 1] = AGENT_DIR_TICK
            elif adir[i] == 2:
                img[y0 + c - 1 : y0 + c + 1, x0 + c - half : x0 + c] = AGENT_DIR_TICK
            else:
                img[y0 + c - 1 : y0 + c + 1, x0 + c : x0 + c + half] = AGENT_DIR_TICK
        return img

    # -- human display ----------------------------------------------------------

    def _display(self, frame: np.ndarray) -> None:
        try:
            import matplotlib

            if matplotlib.get_backend().lower() == "agg":
                return  # headless: nothing to show
            import matplotlib.pyplot as plt

            if self._fig is None:
                plt.ion()
                self._fig, ax = plt.subplots(
                    figsize=(frame.shape[1] / 100, frame.shape[0] / 100)
                )
                ax.axis("off")
                self._img_artist = ax.imshow(frame)
            else:
                self._img_artist.set_data(frame)
            self._fig.canvas.draw_idle()
            self._fig.canvas.flush_events()
        except Exception:
            pass  # rendering must never take down the env

    def close(self):
        if self._fig is not None:
            import matplotlib.pyplot as plt

            plt.close(self._fig)
            self._fig = None


class InteractiveViewer(Viewer):
    """Windowed interactive viewer with key-press hooks.

    The GL-free equivalent of the reference's pyglet window
    (the reference's ``rware/rendering.py:85-137``), which ``human_play``
    hooks via ``viewer.window.on_key_press``: here a GUI matplotlib figure
    is the window and ``viewer.on_key_press`` (a callable taking the
    matplotlib key name, e.g. ``"up"``, ``"tab"``, ``" "``) is the hook.
    Raises ``RuntimeError`` under a headless Agg backend so callers can
    fall back to the curses TUI.
    """

    def __init__(self, config: WarehouseConfig):
        super().__init__(config)
        import matplotlib

        if "agg" in matplotlib.get_backend().lower():
            raise RuntimeError(
                "no GUI matplotlib backend available (headless display)"
            )
        import matplotlib.pyplot as plt

        plt.ion()
        h, w = self.layout.grid_size
        blank = np.zeros((h * CELL + 1, w * CELL + 1, 3), dtype=np.uint8)
        self._fig, ax = plt.subplots(
            figsize=(blank.shape[1] / 72, blank.shape[0] / 72)
        )
        self._fig.canvas.manager.set_window_title("rware_tpu_torch")
        ax.axis("off")
        self._img_artist = ax.imshow(blank)
        self.on_key_press = None
        self._fig.canvas.mpl_connect("key_press_event", self._handle_key)

    def _handle_key(self, event) -> None:
        if self.on_key_press is not None and event.key is not None:
            self.on_key_press(event.key)

    def show(self, state, env: int = 0) -> None:
        """Render one frame into the window and pump GUI events."""
        self._img_artist.set_data(self.frame(state, env))
        self._fig.canvas.draw_idle()
        self._fig.canvas.flush_events()

    @property
    def open(self) -> bool:
        import matplotlib.pyplot as plt

        return self._fig is not None and plt.fignum_exists(
            self._fig.number
        )
