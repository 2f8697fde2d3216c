"""Interactive warehouse play: ``python -m rware_tpu_torch.human_play``.

The port's counterpart of the root ``human_play.py``: the same argparse
surface (--env/--max_steps/--display_info/--seed/--backend/--keys) and key
maps, played through :func:`rware_tpu_torch.gym_adapter.make_gym` on
``--device`` (the card unless the caller asks for ``cpu``) with a graphical
window (:class:`rware_tpu_torch.rendering.InteractiveViewer`) or a curses
TUI that works over SSH and with no display.

Key bindings (``--keys``):
  reference (default) — the reference's exact map (rware human_play.py
    _key_press): UP = forward, LEFT/RIGHT = rotate, P/L = toggle load,
    SPACE = noop, TAB = next agent, R = reset, H = help, D = toggle info,
    ESC/Q = quit.
  friendly — arrows/WASD rotate-toward-or-forward, SPACE = toggle load,
    TAB = next agent, R = reset, Q = quit.
The controlled agent acts; all others NOOP.
"""
from __future__ import annotations

import argparse
import curses

from rware_tpu_torch.types import Action, Direction


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", default="rware-tiny-2ag-v2")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument(
        "--display_info", action="store_true", help="show rewards/info each step"
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    p.add_argument(
        "--backend", choices=["auto", "curses", "window"], default="auto",
        help="window = graphical viewer with key hooks (needs a display, "
        "the reference's pyglet-window equivalent); curses = terminal TUI; "
        "auto tries window, falls back to curses",
    )
    p.add_argument(
        "--keys", choices=["reference", "friendly"], default="reference",
        help="key map: 'reference' matches the reference human_play.py "
        "(UP forward, LEFT/RIGHT rotate, P/L load, SPACE noop, H help, "
        "D info); 'friendly' = arrows/WASD rotate-toward-or-forward, "
        "SPACE load",
    )
    return p.parse_args(argv)


HELP_REFERENCE = (
    "UP forward | LEFT/RIGHT rotate | P/L toggle load | SPACE noop | "
    "TAB next agent | R reset | H help | D info | ESC/Q quit"
)
HELP_FRIENDLY = (
    "arrows/WASD rotate-toward-or-forward | SPACE toggle load | "
    "TAB next agent | R reset | Q quit"
)

# friendly mode: rotation order UP -> RIGHT -> DOWN -> LEFT (clockwise)
_CLOCK = {0: 3, 3: 1, 1: 2, 2: 0}


def dispatch_key(mode: str, key: str, cur_dir: int):
    """Map a normalised key name to a play command, shared by both
    backends.  Returns ("action", int_action) | ("cycle",) | ("reset",) |
    ("quit",) | ("help",) | ("toggle_info",) | None.

    ``mode="reference"`` reproduces the reference's _key_press map
    (the reference's ``human_play.py:114-147``) exactly; ``"friendly"`` keeps
    the rotate-toward-or-forward scheme.  ``key`` is lowercase: "up",
    "down", "left", "right", "tab", "escape", " ", or a letter."""
    if key == "tab":
        return ("cycle",)
    if key == "r":
        return ("reset",)
    if mode == "reference":
        if key in ("escape", "q"):
            return ("quit",)
        if key == "up":
            return ("action", int(Action.FORWARD))
        if key == "left":
            return ("action", int(Action.LEFT))
        if key == "right":
            return ("action", int(Action.RIGHT))
        if key in ("p", "l"):
            return ("action", int(Action.TOGGLE_LOAD))
        if key == " ":
            return ("action", int(Action.NOOP))
        if key == "h":
            return ("help",)
        if key == "d":
            return ("toggle_info",)
        return None
    # friendly
    if key == "q":
        return ("quit",)
    if key == " ":
        return ("action", int(Action.TOGGLE_LOAD))
    want = {
        "up": Direction.UP, "w": Direction.UP,
        "down": Direction.DOWN, "s": Direction.DOWN,
        "left": Direction.LEFT, "a": Direction.LEFT,
        "right": Direction.RIGHT, "d": Direction.RIGHT,
    }.get(key)
    if want is None:
        return None
    want = int(want)
    if cur_dir == want:
        return ("action", int(Action.FORWARD))
    if _CLOCK[cur_dir] == want:
        return ("action", int(Action.RIGHT))
    return ("action", int(Action.LEFT))


DIR_GLYPH = {0: "^", 1: "v", 2: "<", 3: ">"}


def draw(stdscr, env, state, selected, msg, display_info, last,
         help_line=HELP_FRIENDLY):
    from rware_tpu_torch.core.host import env_to_host
    from rware_tpu_torch.rendering import FRAME_FIELDS

    stdscr.erase()
    h, w = env.grid_size
    highways = env.highways
    goals = set(env.goals)
    f = env_to_host(state, 0, FRAME_FIELDS)  # one copy
    sx, sy = f["shelf_x"], f["shelf_y"]
    req = set(f["request_queue"].tolist())
    ax, ay = f["agent_x"], f["agent_y"]
    adir, carrying = f["agent_dir"], f["agent_carrying"]

    shelf_at = {(int(x), int(y)): j for j, (x, y) in enumerate(zip(sx, sy))}
    agent_at = {(int(x), int(y)): i for i, (x, y) in enumerate(zip(ax, ay))}

    for y in range(h):
        row = []
        for x in range(w):
            cell = (x, y)
            if cell in agent_at:
                i = agent_at[cell]
                ch = DIR_GLYPH[int(adir[i])]
                if i == selected:
                    ch = ch.upper() if ch.isalpha() else ch
                row.append(
                    f"[{ch}]" if carrying[i] >= 0 else f"({ch})"
                    if i == selected
                    else f" {ch}{'#' if carrying[i] >= 0 else ' '}"
                )
            elif cell in shelf_at:
                j = shelf_at[cell]
                row.append(" ▣ " if j in req else " □ ")
            elif cell in goals:
                row.append(" G ")
            elif highways[y, x]:
                row.append(" . ")
            else:
                row.append("   ")
        stdscr.addstr(y, 0, "".join(row))

    stdscr.addstr(
        h + 1, 0,
        f"agent {selected} selected | {help_line}"[: curses.COLS - 1],
    )
    if msg:
        stdscr.addstr(h + 2, 0, msg[: curses.COLS - 1])
    if display_info and last is not None:
        rew, done, info = last
        stdscr.addstr(h + 3, 0, f"rewards={rew} done={done} info={info}"[: curses.COLS - 1])
    stdscr.refresh()


def heading(env, agent: int) -> int:
    """Agent ``agent``'s heading (one copy)."""
    from rware_tpu_torch.core.host import to_host

    return int(to_host(env.state.agent_dir[0, agent])[0])


def make_env(args):
    from rware_tpu_torch.gym_adapter import make_gym

    return make_gym(args.env, device=args.device, max_steps=args.max_steps or 500,
                    render_mode="rgb_array")


def main(stdscr, args, env=None):
    curses.curs_set(0)
    stdscr.nodelay(False)

    env = env or make_env(args)
    env.reset(seed=args.seed)
    selected = 0
    steps = 0
    last = None
    display_info = args.display_info
    help_line = HELP_REFERENCE if args.keys == "reference" else HELP_FRIENDLY
    msg = f"{args.env}: {env.n_agents} agents, grid {env.grid_size}"

    NAMES = {
        curses.KEY_UP: "up", curses.KEY_DOWN: "down",
        curses.KEY_LEFT: "left", curses.KEY_RIGHT: "right",
        ord("\t"): "tab", 27: "escape", ord(" "): " ",
    }

    while True:
        draw(stdscr, env, env.state, selected, msg, display_info, last,
             help_line)
        key = stdscr.getch()
        name = NAMES.get(key)
        if name is None and 0 <= key < 256 and chr(key).isprintable():
            name = chr(key).lower()
        if name is None:
            continue
        cmd = dispatch_key(args.keys, name, heading(env, selected))
        if cmd is None:
            continue
        if cmd[0] == "quit":
            break
        if cmd[0] == "cycle":
            selected = (selected + 1) % env.n_agents
            continue
        if cmd[0] == "reset":
            env.reset(seed=args.seed + steps)
            last = None
            continue
        if cmd[0] == "help":
            msg = help_line
            continue
        if cmd[0] == "toggle_info":
            display_info = not display_info
            continue
        action = cmd[1]
        acts = [0] * env.n_agents
        acts[selected] = action
        obs, rew, done, trunc, info = env.step(acts)
        last = (rew, done, info)
        steps += 1
        if done:
            msg = f"episode done after {steps} steps — R to reset"


def main_window(args, env=None) -> bool:
    """Windowed play via rendering.InteractiveViewer (the reference's
    pyglet-window surface, rware/rendering.py:85-137 + human_play.py:70).

    Returns False when no GUI backend exists so the caller can fall back.
    """
    import time

    from rware_tpu_torch.rendering import InteractiveViewer

    env = env or make_env(args)
    try:
        viewer = InteractiveViewer(env.config)
    except RuntimeError as e:
        print(f"windowed viewer unavailable ({e})")
        return False
    env.reset(seed=args.seed)
    state = {"selected": 0, "steps": 0, "info": args.display_info}
    help_line = HELP_REFERENCE if args.keys == "reference" else HELP_FRIENDLY

    def on_key(key):
        cmd = dispatch_key(args.keys, key, heading(env, state["selected"]))
        if cmd is None:
            # friendly mode keeps q/escape as quit even when unmapped
            if key == "escape":
                viewer.close()
            return
        if cmd[0] == "quit":
            viewer.close()
            return
        if cmd[0] == "cycle":
            state["selected"] = (state["selected"] + 1) % env.n_agents
            return
        if cmd[0] == "reset":
            env.reset(seed=args.seed + state["steps"])
            viewer.show(env.state)
            return
        if cmd[0] == "help":
            print(help_line)
            return
        if cmd[0] == "toggle_info":
            state["info"] = not state["info"]
            return
        acts = [0] * env.n_agents
        acts[state["selected"]] = cmd[1]
        obs, rew, done, trunc, info = env.step(acts)
        state["steps"] += 1
        if state["info"]:
            print(f"rewards={rew} done={done} info={info}")
        viewer.show(env.state)

    viewer.on_key_press = on_key
    viewer.show(env.state)
    print(f"{args.env}: {help_line} (focus the window)")
    while viewer.open:
        viewer._fig.canvas.flush_events()
        time.sleep(0.03)
    return True


def run(argv=None) -> int:
    """The command line: the window, else (or with ``--backend curses``)
    the terminal.  The env is made first, so a missing device raises before
    any window or terminal is touched."""
    args = parse_args(argv)
    env = make_env(args)
    if args.backend in ("auto", "window"):
        if main_window(args, env):
            return 0
        if args.backend == "window":
            return 1
    curses.wrapper(main, args, env)
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
