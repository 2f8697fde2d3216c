"""The fused rollout kernel (K1) and the fused collector kernels: MLP (K2a),
recurrent (K2c), per-agent MLP (K2d) and per-agent recurrent (K2d′).

* :func:`build_fused_rollout` replaces
  ``rware_tpu/ops/pallas_rollout.py::build_pallas_rollout``: T env steps per
  launch with random or scripted actions and autoreset, returning the final
  state, per-agent reward sums and episode counts.
* :func:`build_fused_collect` replaces ``build_pallas_collect`` in mode
  ``policy="mlp"``: per step the observation, the
  shared :class:`ActorCritic` forward, a Gumbel-argmax sample and the env
  step, with the trajectory streamed out in the ``(T, B, N, ...)`` layout.
* :func:`build_fused_collect_gru` replaces ``build_pallas_collect`` in mode
  ``policy="gru"``: the same step with the shared
  :class:`RecurrentActorCritic` (embed + GRU cell + f32 heads), the
  ``(B, N, Hg)`` bf16 carry kept on the card for the whole rollout and zeroed
  where an episode ends.
* :func:`build_fused_collect_per_agent` replaces ``build_pallas_collect`` in
  mode ``policy="mlp_per_agent"`` (SEAC's collector): K2a's step where agent i
  runs its own :class:`ActorCritic` i.
* :func:`build_fused_collect_gru_per_agent` replaces ``build_pallas_collect``
  in mode ``policy="gru_per_agent"`` (recurrent SEAC's collector, K2d′): K2c's
  step where agent i runs its own :class:`RecurrentActorCritic` i on its own
  slice of the carry.

Every registered id takes every collector, the sensor ranges 2-5 of
``register_full`` (up to 1,097 features a row) included: where a block cannot
hold the shared network beside its smallest tile, K2a reads its weights from
device memory (:func:`collect_plan`), and where it cannot hold the tile's
whole observation rows (K2d and K2d′ with many agents at sensor range 4 and
5), the kernel builds and sums the observation in chunks of features, each
sum the same FMA chain as the whole row's.

Image observations (IMAGE and IMAGE_DICT ids, ``-img`` / ``-imgdict`` /
``-Nd``) are a mode of every collector (K2e, ``_build_image_feats`` of
``pallas_rollout.py``): the kernel builds each agent's C x w x w window of
the config's image layers, rotated into its heading unless the id is
non-directional, plus the 6 self features for IMAGE_DICT, and the trajectory
holds it flattened, ``policy_obs_length`` features per agent; the plain
versions take :func:`~rware_tpu_torch.core.engine.build_policy_obs_fn`.
Messages are then sampled and fed back but not observed.

Message bits (``msg_bits`` M > 0) are a mode of K1 and of every collector
(K2b, ``_sample_bernoulli`` of ``pallas_rollout.py``): the state carries
every agent's M bits, the observations show them, K1 sets them from its
actions (scripted) or from Philox purpose MESSAGE (random), and the
collectors sample them from the policy's Bernoulli message head, add their
log-probability to the move's and return them as ``traj["bits"]`` (T, B, N,
M) int32; an episode's end clears them.

K1 runs one thread an env with the env kept compact on the card, a map from
cell to shelf in place of the shelves' list (:func:`rollout_plan`: a tile of
envs a block in shared memory, or in device memory where the batch would take
more than two waves of tiles, or for a grid too large for a tile the env in local
memory with scans, as the kernel before it).  The map holds one shelf a cell,
which the dynamics keep: no two shelves ever share a cell in a state that
``reset`` and ``step`` make, and K1 takes such states.

Each wrapper launches its CUDA kernel (``csrc/fused_rollout.cu``,
``csrc/collect_mlp.cuh`` for K2a and K2d, launched from
``csrc/fused_collect.cu``, its chunked instantiations built in
``csrc/fused_collect_chunked.cu``; ``csrc/collect_gru.cuh`` for K2c and
K2d′, launched from ``csrc/fused_collect_gru.cu``, which builds K2d′'s
FLATTENED instantiations, the others built in
``csrc/fused_collect_gru_one_stack.cu`` (K2c),
``csrc/fused_collect_gru_image.cu`` and
``csrc/fused_collect_gru_image_one_stack.cu`` (K2d′ and K2c on images),
``csrc/fused_collect_gru_chunked.cu`` and
``csrc/fused_collect_gru_chunked_image.cu``) for tensors on
a CUDA device, and runs its plain PyTorch version (``.plain``)
only for tensors on the CPU; it counts its kernel launches in ``.launches``.  Both draw from the same Philox stream
(:mod:`rware_tpu_torch.ops.philox`), so kernel and plain version agree bit
for bit in every mode.  Every launch takes ``env_offset``, the global index of
its first env: env i draws from the counter of env ``env_offset + i``, so a
launch on rows ``[o, o + b)`` of a batch with ``env_offset = o`` equals those
rows of the launch on the whole batch, bit for bit (data-parallel training
runs each rank's shard so).  Scripted (K1) and deterministic (K2a) modes draw
zeros: lowest-index queue replacement, agent i respawning at cell i facing
UP, the queue restarting as 0..R-1 — the TPU kernels' scripted rules.

The kernels take the state packed as one (ROWS, B) int32 tensor with the
env index minor (rows: agent x, y, dir, carrying, has_delivered; shelf x, y;
queue; inactive and step counters; messages), so their loads are coalesced;
the transposes from and to the public (B, ...) layout live here.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.core.engine import (
    build_policy_obs_fn,
    build_reset_fn,
    build_transition_fn,
    n_reset_draws,
)
from rware_tpu_torch.core.state import WarehouseState
from rware_tpu_torch.models.networks import (
    ActorCritic,
    RecurrentActorCritic,
    gru_collect_step,
    gru_to_arrays,
    sample_action,
    sample_bernoulli,
    stacked_heads,
)
from rware_tpu_torch.ops import philox
from rware_tpu_torch.ops.fused_update import SMEM_PER_SM
from rware_tpu_torch.types import ObservationType

# Limits of the kernels' per-thread state arrays (csrc/env_core.cuh) and of
# the image layer table (csrc/collect_core.cuh).
MAX_AGENTS, MAX_SHELVES, MAX_QUEUE, MAX_MSG_BITS, MAX_LAYERS = 32, 512, 64, 8, 7
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
IMAGE_TYPES = (ObservationType.IMAGE, ObservationType.IMAGE_DICT)
TRAJ_KEYS = ("obs", "action", "logp", "value", "reward", "done")


def _check_config(config: WarehouseConfig) -> None:
    layout = config.compile_layout()
    if (config.n_agents > MAX_AGENTS or layout.n_shelves > MAX_SHELVES
            or config.request_queue_size > MAX_QUEUE or config.msg_bits > MAX_MSG_BITS):
        raise ValueError(
            f"the fused kernels take at most {MAX_AGENTS} agents, {MAX_SHELVES} "
            f"shelves, a queue of {MAX_QUEUE} and {MAX_MSG_BITS} message bits"
        )


def _check_state(config: WarehouseConfig, state: WarehouseState) -> None:
    """The kernels index the packed state by the config's sizes."""
    want = (config.n_agents, config.compile_layout().n_shelves, config.request_queue_size)
    got = (state.n_agents, state.n_shelves, state.request_queue.shape[1])
    if got != want or state.batch_size < 1:
        raise ValueError(
            f"state of {state.batch_size} envs with (agents, shelves, queue) {got}; "
            f"the config needs at least 1 env and {want}"
        )


def _check_seed(seed) -> int:
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return seed


def _check_env_offset(env_offset, b: int) -> int:
    """The launch's first global env index (the counter's env word is
    ``env_offset + i``, 32 bits)."""
    env_offset = int(env_offset)
    if not (0 <= env_offset and env_offset + b <= 2**32):
        raise ValueError(f"env_offset={env_offset} with {b} envs leaves the 32-bit env word")
    return env_offset


def pack_state(state: WarehouseState) -> torch.Tensor:
    """(ROWS, B) int32, env index minor; the N * M message rows last,
    agent-major."""
    rows = [
        state.agent_x, state.agent_y, state.agent_dir, state.agent_carrying,
        state.agent_has_delivered, state.shelf_x, state.shelf_y,
        state.request_queue, state.cur_inactive_steps[:, None],
        state.cur_steps[:, None], state.agent_message.reshape(state.batch_size, -1),
    ]
    return torch.cat([r.to(torch.int32) for r in rows], dim=1).t().contiguous()


def unpack_state(packed: torch.Tensor, like: WarehouseState) -> WarehouseState:
    """Inverse of :func:`pack_state`; ``like`` gives the field shapes."""
    n, s, r = like.n_agents, like.n_shelves, like.request_queue.shape[1]
    m = like.agent_message.shape[2]
    cols = packed.t()
    sizes = [n, n, n, n, n, s, s, r, 1, 1, n * m]
    ax, ay, ad, carry, hd, sx, sy, q, inact, steps, msg = torch.split(cols, sizes, dim=1)
    return WarehouseState(
        agent_x=ax.contiguous(),
        agent_y=ay.contiguous(),
        agent_dir=ad.contiguous(),
        agent_carrying=carry.contiguous(),
        agent_has_delivered=hd != 0,
        agent_message=msg.to(torch.float32).reshape(msg.shape[0], n, m),
        shelf_x=sx.contiguous(),
        shelf_y=sy.contiguous(),
        request_queue=q.contiguous(),
        cur_steps=steps[:, 0].contiguous(),
        cur_inactive_steps=inact[:, 0].contiguous(),
    )


def layout_buffer(config: WarehouseConfig, device) -> torch.Tensor:
    """[slot_x (S) | slot_y (S) | goal_x (G) | goal_y (G) | highway (H*W)]."""
    layout = config.compile_layout()
    parts = [
        layout.shelf_slots[:, 0], layout.shelf_slots[:, 1],
        layout.goals[:, 0], layout.goals[:, 1], layout.highways.reshape(-1),
    ]
    buf = np.concatenate([np.asarray(p, dtype=np.int32) for p in parts])
    return torch.from_numpy(buf).to(device)


def _dims(config: WarehouseConfig) -> list:
    layout = config.compile_layout()
    h, w = layout.grid_size
    return [
        config.n_agents, layout.n_shelves, config.request_queue_size,
        layout.n_goals, h, w, int(config.reward_type),
        config.max_steps or 0, config.max_inactivity_steps or 0, config.msg_bits,
    ]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


class _Draws:
    """Per-step draws of the plain versions: Philox keyed by the envs' global
    indices ``env_offset + i``, or zeros when the mode is scripted /
    deterministic."""

    def __init__(self, config: WarehouseConfig, seed: int, zero: bool, b: int, device,
                 env_offset: int = 0):
        self.seed, self.zero, self.b = seed, zero, b
        self.envs = philox.env_ids(b, env_offset, device)
        self.n_goals = config.compile_layout().n_goals
        self.n_reset = n_reset_draws(config)
        self.n_msg = config.n_agents * config.msg_bits

    def __call__(self, step: int, purpose: int, n: int) -> torch.Tensor:
        if self.zero:
            return torch.zeros((self.b, n), dtype=torch.int64, device=self.envs.device)
        return philox.uniform_bits(self.seed, self.envs, step, purpose, n)

    def queue(self, step):
        return self(step, philox.QUEUE, self.n_goals)

    def respawn(self, step):
        return self(step, philox.RESPAWN, self.n_reset)

    def message(self, step):
        """(B, N * M) draws of the message bits, agent-major."""
        return self(step, philox.MESSAGE, self.n_msg)


# K1's routes (csrc/fused_rollout.cu): the compact env in shared memory, a tile
# of envs a block; the compact env in device memory; the env in local memory
# with the shelves as a list of cells, found by scans (the kernel before the map).
ROLLOUT_ROUTES = ("shared", "global", "scan")
# The regions of K1's compact env, in rows (a word each, env-minor): agents (two
# words each), reward sums, queue, the inactive and step counters, the map.
ROLLOUT_REGIONS = ("agents", "reward", "queue", "count", "map")
ROLLOUT_TES = (128, 64, 32)  # envs (threads) a block, largest first
# Waves of tiles the shared route takes a batch in, at most: on an H100 at
# B=65,536 large-8ag's two waves beat device memory, 5x5-4ag's four lost to it
# (PERF.md §6).
ROLLOUT_MAX_WAVES = 2
SM_COUNT = 132  # streaming multiprocessors of an H100 SXM


@dataclasses.dataclass(frozen=True)
class RolloutPlan:
    """The launch plan of the fused rollout kernel (K1): the ``route`` (of
    :data:`ROLLOUT_ROUTES`), ``te`` envs (threads) a block, the bytes of a
    map entry (1, or 2 from 255 shelves; 0 on the scan route), the
    ``stride`` in words between two rows of an env (the tile, or the batch
    rounded up to 32 in device memory), and the first row of each of
    :data:`ROLLOUT_REGIONS` with their end.  ``args`` is what
    ``rw_fused_rollout`` takes, which refuses a plan whose regions do not hold
    what the kernel keeps there."""

    route: str
    te: int
    map_bytes: int
    stride: int
    offsets: Tuple[int, ...]

    regions = ROLLOUT_REGIONS

    def region(self, name: str) -> Tuple[int, int]:
        """(first, end) row of region ``name``."""
        k = self.regions.index(name)
        return self.offsets[k], self.offsets[k + 1]

    @property
    def rows(self) -> int:
        """Words of one env's compact state."""
        return self.offsets[-1]

    @property
    def smem(self) -> int:
        """Bytes of a block's shared memory (the shared route's tile)."""
        return 4 * self.rows * self.stride if self.route == "shared" else 0

    @property
    def scratch_words(self) -> int:
        """Words of device memory the global route keeps the envs in."""
        return self.rows * self.stride if self.route == "global" else 0

    def blocks(self, n_envs: int) -> int:
        return -(-n_envs // self.te)

    def waves(self, n_envs: int) -> int:
        """Rounds of ``blocks_per_sm`` blocks on every SM that ``n_envs`` take."""
        return -(-self.blocks(n_envs) // (SM_COUNT * self.blocks_per_sm))

    @property
    def blocks_per_sm(self) -> int:
        """Blocks an SM holds by shared memory, threads and the kernel's
        128 registers a thread."""
        per = min(2048 // self.te, 32, 65536 // (128 * self.te))
        return min(per, SMEM_PER_SM // (self.smem + 1024)) if self.route == "shared" else per

    @property
    def carveout(self) -> int:
        """The shared-memory carve-out, in percent of an SM's: what
        ``blocks_per_sm`` tiles need on the shared route, none (all L1) on the
        others."""
        if self.route != "shared":
            return 0
        return -(-100 * self.blocks_per_sm * (self.smem + 1024) // SMEM_PER_SM)

    def args(self) -> list:
        return [ROLLOUT_ROUTES.index(self.route), self.te, self.map_bytes, self.stride,
                self.carveout, *self.offsets]


def rollout_plan(config: WarehouseConfig, batch: int, route: Optional[str] = None) -> RolloutPlan:
    """K1's plan for ``batch`` envs of ``config``.  The tile is the largest of
    :data:`ROLLOUT_TES` that gives every SM a block (32 for small batches);
    the compact env (2N + N + R + 2 words and the map) is kept in shared
    memory where the batch takes at most :data:`ROLLOUT_MAX_WAVES` waves of
    such tiles, else in device memory;
    a grid whose compact env does not fit a tile of 32 in shared memory keeps
    the scan route.  ``route`` forces one (the scan route takes any config;
    the shared route only a compact env that fits a tile of 32).  No config
    the kernel takes is refused."""
    _check_config(config)
    if batch < 1:
        raise ValueError("K1 takes at least one env")
    if route is not None and route not in ROLLOUT_ROUTES:
        raise ValueError(f"route must be one of {ROLLOUT_ROUTES}, got {route!r}")
    layout = config.compile_layout()
    h, w = layout.grid_size
    n, s, r = config.n_agents, layout.n_shelves, config.request_queue_size
    map_bytes = 1 if s < 255 else 2
    sizes = [2 * n, n, r, 2, -(-h * w * map_bytes // 4)]
    offsets = [0]
    for size in sizes:
        offsets.append(offsets[-1] + size)
    fits = 4 * offsets[-1] * ROLLOUT_TES[-1] <= SMEM_LIMIT and max(h, w) < 65536
    te = next((te for te in ROLLOUT_TES if -(-batch // te) >= SM_COUNT), ROLLOUT_TES[-1])
    if route is None:
        route = "scan"
        if fits:
            tile = next((t for t in ROLLOUT_TES if t <= te and 4 * offsets[-1] * t <= SMEM_LIMIT))
            shared = RolloutPlan("shared", tile, map_bytes, tile, tuple(offsets))
            route = "shared" if shared.waves(batch) <= ROLLOUT_MAX_WAVES else "global"
    if route == "scan":
        return RolloutPlan("scan", te, 0, te, (0,) * (len(ROLLOUT_REGIONS) + 1))
    if route == "shared":
        if not fits:
            raise ValueError("the compact env does not fit a tile of 32 in shared memory")
        te = next((t for t in ROLLOUT_TES if t <= te and 4 * offsets[-1] * t <= SMEM_LIMIT))
        return RolloutPlan("shared", te, map_bytes, te, tuple(offsets))
    if max(h, w) >= 65536:
        raise ValueError("the compact env takes grids of at most 65,535 rows and columns")
    return RolloutPlan("global", te, map_bytes, _up(batch, 32), tuple(offsets))


class FusedRollout:
    """``rollout(state, seed, actions=None) -> (state, rewards_sum (B, N)
    f32, episodes (B,) int32)``; see :func:`build_fused_rollout`.  ``route``
    (None: the plan's choice) forces one of :data:`ROLLOUT_ROUTES`;
    :meth:`plan` gives a batch's launch plan."""

    def __init__(self, config: WarehouseConfig, n_steps: int, scripted: bool = False):
        _check_config(config)
        self.config = config
        self.n_steps = n_steps
        self.scripted = scripted
        self.launches = 0
        self.route: Optional[str] = None
        self._transition = build_transition_fn(config)
        self._reset = build_reset_fn(config)
        self._layouts: Dict[torch.device, torch.Tensor] = {}

    def _check_actions(self, state, actions):
        m = self.config.msg_bits
        if self.scripted != (actions is not None):
            raise ValueError("scripted mode takes actions (T, B, N), or (T, B, N, 1 + M) with "
                             "message bits; random mode takes none")
        if actions is not None:
            want = (self.n_steps, state.batch_size, self.config.n_agents) + ((1 + m,) if m else ())
            if tuple(actions.shape) != want or actions.device != state.device:
                raise ValueError(f"actions must be {want} on {state.device}")

    def __call__(self, state: WarehouseState, seed, actions: Optional[torch.Tensor] = None,
                 env_offset: int = 0):
        _check_state(self.config, state)
        self._check_actions(state, actions)
        seed = _check_seed(seed)
        env_offset = _check_env_offset(env_offset, state.batch_size)
        if state.device.type == "cuda":
            return self._launch(state, seed, actions, env_offset)
        if state.device.type == "cpu":
            return self.plain(state, seed, actions, env_offset)
        raise ValueError(f"no fused rollout for device {state.device}")

    def plain(self, state: WarehouseState, seed, actions: Optional[torch.Tensor] = None,
              env_offset: int = 0):
        """The plain PyTorch version: T steps of the batched engine with the
        kernel's draws."""
        self._check_actions(state, actions)
        seed = _check_seed(seed)
        b, n = state.batch_size, self.config.n_agents
        draws = _Draws(self.config, seed, self.scripted, b, state.device, env_offset)
        rew = torch.zeros((b, n), dtype=torch.float32, device=state.device)
        epis = torch.zeros(b, dtype=torch.int32, device=state.device)
        for t in range(self.n_steps):
            if self.scripted:
                acts = actions[t]
            else:
                acts = philox.rand_mod(draws(t, philox.ACTION, n), 5)
                if self.config.msg_bits:
                    bits = philox.rand_mod(draws.message(t), 2).reshape(b, n, -1)
                    acts = torch.cat([acts[..., None], bits], dim=-1)
            state, rewards, done, _ = self._transition(state, acts, draws.queue(t))
            state = self._reset(draws.respawn(t)).where(done, state)
            rew = rew + rewards
            epis = epis + done.to(torch.int32)
        return state, rew, epis

    def plan(self, batch: int) -> RolloutPlan:
        """The launch plan for ``batch`` envs (:func:`rollout_plan`)."""
        return rollout_plan(self.config, batch, self.route)

    def _launch(self, state, seed, actions, env_offset):
        from rware_tpu_torch.ops._build import check, load_library

        lib = load_library()
        dev = state.device
        b, n = state.batch_size, self.config.n_agents
        if dev not in self._layouts:
            self._layouts[dev] = layout_buffer(self.config, dev)
        plan = self.plan(b)
        with torch.cuda.device(dev):
            packed = pack_state(state)
            out = torch.empty_like(packed)
            acts = None
            if actions is not None:
                acts = actions.to(torch.int32).reshape(actions.shape[:3] + (1 + self.config.msg_bits,))
                acts = acts.permute(0, 2, 3, 1).contiguous()  # (T, N, 1 + M, B)
            rewards = torch.empty((n, b), dtype=torch.float32, device=dev)
            episodes = torch.empty(b, dtype=torch.int32, device=dev)
            scratch = None
            if plan.scratch_words:
                scratch = torch.empty(plan.scratch_words, dtype=torch.int32, device=dev)
            args = plan.args()
            plan_buf = (ctypes.c_int * len(args))(*args)
            code = lib.rw_fused_rollout(
                *_dims(self.config), seed, env_offset, int(self.scripted), self.n_steps, b,
                ctypes.addressof(plan_buf), len(args), _ptr(self._layouts[dev]), _ptr(packed),
                _ptr(out), _ptr(acts), _ptr(rewards), _ptr(episodes), _ptr(scratch),
                torch.cuda.current_stream(dev).cuda_stream,
            )
            check(lib, code, "fused_rollout")
            self.launches += 1
        return unpack_state(out, state), rewards.t().contiguous(), episodes


def build_fused_rollout(config: WarehouseConfig, n_steps: int, scripted: bool = False) -> FusedRollout:
    """Returns ``rollout(state, seed, actions=None, env_offset=0) -> (state,
    rewards_sum (B, N) f32, episodes (B,) int32)`` (the contract of
    ``pallas_rollout.py:666-677``).  Random mode takes no actions; scripted
    mode takes (T, B, N) int actions, or (T, B, N, 1 + M) with message bits
    (move in column 0).  ``seed`` keys the Philox stream; env i draws as env
    ``env_offset + i`` of a global batch, so a shard's launch equals those
    rows of the global launch."""
    return FusedRollout(config, n_steps, scripted)


# The regions of a collector block's shared memory, in order (csrc/
# collect_mlp.cuh): dense_0, dense_1, the policy, value and message heads and
# their five biases (the weight stacks, empty where they are read from device
# memory), the observation tile (empty: at the start of ``h``, h1 written over
# it; ``kx`` features of it where the plan chunks it), the hidden tile, h2
# (empty: over h1), a record a row (head outputs, then action, logp, reward,
# bits), a view of each env's state (agents, queue, shelves: what the
# observation rows read), and per env done.
COLLECT_REGIONS = ("w0", "w1", "wp", "wv", "wm", "b0", "b1", "bp", "bv", "bm",
                   "x", "h", "h2", "out", "view", "done")
COLLECT_ROWS = 128  # (env, agent) rows a block aims at: 64 envs at 2 agents
COLLECT_MIN_ROWS = 32  # K2a's smallest tile: the 32 one-env columns of the kernel before
COLLECT_MAX_THREADS = 512
# Observation features a chunk of the tile holds where the whole tile does not
# fit a block, longest first: multiples of 32, so a chunk's rows go to the
# trajectory in whole runs of 8 features (16 bytes) and line up with the
# recurrent collector's weight ring (chunks of up to 32 rows)
COLLECT_CHUNKS = (256, 128, 64, 32)


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class CollectPlan:
    """The launch plan of the MLP collector (K2a, K2d and their message and
    image modes): ``te`` envs a block, ``threads``, the tile's ``rows`` (N x
    te (env, agent) rows, agent-major, padded to 8) and their stride ``rs``
    in the feature-major tiles, the words ``hrs`` of a row's record and
    ``vs`` of an env's view, the weight route, the shared-memory carve-out
    (percent of an SM's) for ``blocks_per_sm`` blocks, the byte offsets
    of :data:`COLLECT_REGIONS` with their end (the block's dynamic shared
    memory), and ``kx``, the observation features a chunk of the tile holds
    (0: the whole row; else the kernel builds and sums dense_0 chunk by chunk).
    ``args`` is what ``rw_fused_collect`` takes, which refuses a plan whose
    regions do not hold what the kernel keeps there."""

    te: int
    threads: int
    rows: int
    rs: int
    hrs: int
    vs: int
    weights_global: bool
    offsets: Tuple[int, ...]
    kx: int = 0

    @property
    def smem(self) -> int:
        return self.offsets[-1]

    regions = COLLECT_REGIONS

    def region(self, name: str) -> Tuple[int, int]:
        """(start, end) in bytes of region ``name``."""
        k = self.regions.index(name)
        return self.offsets[k], self.offsets[k + 1]

    def blocks(self, n_envs: int) -> int:
        return -(-n_envs // self.te)

    @property
    def blocks_per_sm(self) -> int:
        """Blocks an SM holds by shared memory and registers (the kernel is
        built for at most 128 a thread, 65,536 an SM)."""
        return min(SMEM_PER_SM // (self.smem + 1024), 65536 // (128 * self.threads))

    @property
    def carveout(self) -> int:
        """The smallest shared-memory carve-out, in percent of an SM's, that
        holds ``blocks_per_sm`` blocks: the rest is L1."""
        return -(-100 * self.blocks_per_sm * (self.smem + 1024) // SMEM_PER_SM)

    def args(self) -> list:
        return [self.te, self.threads, self.rows, self.rs, self.hrs, self.vs,
                int(self.weights_global), self.carveout, self.kx, *self.offsets]


def _collect_layout(obs_len: int, hidden: Sequence[int], n_agents: int, msg_bits: int,
                    view: int, n_stacks: int, weights_global: bool, te: int,
                    x_in_h: bool, kx: int = 0) -> Optional[CollectPlan]:
    """The plan of tile ``te`` with the observation tile under h1 or beside
    it (``kx`` > 0: a chunk of ``kx`` features of it beside h1, every job of
    dense_0 a thread of its own, whose sums stay in registers over the
    chunks), or None where that does not fit a block."""
    h1, h2 = hidden
    rows = _up(n_agents * te, 8)
    heads = 5 + 1 + msg_bits
    jobs0, jobs1 = (rows // 8) * (h1 // 8), (rows // 8) * (h2 // 8)  # 8 x 8 register tiles
    # a thread a job where it can, and 32 more than the rows (they store while
    # the rows build their observations)
    threads = _up(max(min(max(jobs0, jobs1), COLLECT_MAX_THREADS), rows + 32, 64), 32)
    if threads > COLLECT_MAX_THREADS:
        return None
    h2_in_h = jobs1 <= threads  # one tile a thread: written over what it reads
    if (x_in_h or kx) and jobs0 > threads:
        return None
    h_rows = max(h1, obs_len if x_in_h else 0, h2 if h2_in_h else 0)
    ws = 0 if weights_global else n_stacks
    x_rows = kx or (0 if x_in_h else obs_len)
    sizes = [ws * obs_len * h1 * 2, ws * h1 * h2 * 2, ws * 5 * h2 * 4, ws * h2 * 4,
             ws * msg_bits * h2 * 4, ws * h1 * 4, ws * h2 * 4, ws * 5 * 4, ws * 4,
             ws * msg_bits * 4, x_rows * rows * 2, h_rows * rows * 2,
             0 if h2_in_h else h2 * rows * 2, rows * (heads | 1) * 4, te * (view | 1) * 4, te]
    offsets = [0]
    for size in sizes:
        offsets.append(offsets[-1] + _up(size, 16))
    if offsets[-1] > SMEM_LIMIT:
        return None
    return CollectPlan(te, threads, rows, rows, heads | 1, view | 1, weights_global,
                       tuple(offsets), kx)


def collect_plan(config: WarehouseConfig, hidden: Sequence[int], n_stacks: int = 1,
                 weights_global: Optional[bool] = None, chunk: Optional[int] = None) -> CollectPlan:
    """The MLP collector's plan for ``config`` (its observation length, agents
    and message bits), ``hidden`` and ``n_stacks`` weight stacks (1: K2a, N:
    K2d).  K2d's weights are held in shared memory rather than read from
    device memory (or ``weights_global`` says which) where all stacks fit
    beside a tile of 8 envs with the observation tile beside the hidden one:
    the footprint of the kernel before this one (one thread an env), whose
    routes this keeps.  K2a's are read from device memory only where no tile
    holds them (sensor range 4 and 5).  The tile aims at
    :data:`COLLECT_ROWS` rows, with h1 written over the observation tile
    where every job of dense_0 has a thread, and shrinks until two blocks fit
    an SM, or else takes the largest that fits, down to
    :data:`COLLECT_MIN_ROWS` rows (K2a) or 8 envs (K2d, whose 8-row groups
    each run one agent's stack).  Where no route holds the whole observation
    tile (K2d's smallest tile holds 8 N rows: at 17 agents and sensor range
    5 the tile alone passes a block's shared memory), the weights are read
    from device memory and the tile is built and summed in chunks of
    :data:`COLLECT_CHUNKS` features, the longest that keeps two blocks an
    SM.  ``chunk`` 0 asks for the whole tile, a length for that chunk.
    Raises ``ValueError`` where no tile fits."""
    h1, h2 = hidden
    n, m, length = config.n_agents, config.msg_bits, config.policy_obs_length
    layout = config.compile_layout()
    if layout.grid_size[0] * layout.grid_size[1] > 65536:
        raise ValueError("the collector's env view takes grids of at most 65,536 cells")
    # an env's view: agent cells and headings, messages, the queue, shelf cells
    view = 2 * n + n * m + config.request_queue_size + layout.n_shelves
    step = 8 if n_stacks > 1 else 1  # K2d: whole 8-row groups an agent
    te_max = max(step, COLLECT_ROWS // n // step * step)
    te_min = step if n_stacks > 1 else min(te_max, -(-COLLECT_MIN_ROWS // n))
    routes = (False, True) if weights_global is None else (bool(weights_global),)
    tes = range(te_max, te_min - 1, -step)
    for glob in routes if not chunk else ():
        if n_stacks > 1 and glob != routes[-1] and not any(
                _collect_layout(length, (h1, h2), n, m, view, n_stacks, glob, te, False)
                for te in tes):
            continue  # the stacks do not fit beside a tile of the old footprint
        plans = [p for te in tes for x_in_h in (True, False)
                 if (p := _collect_layout(length, (h1, h2), n, m, view, n_stacks, glob, te,
                                          x_in_h))]
        if plans:  # the largest tile that keeps two blocks an SM, else the largest
            return next((p for p in plans if p.blocks_per_sm >= 2), plans[0])
    if chunk != 0 and routes[-1]:  # the tile in chunks, the weights in device memory
        kxs = [k for k in COLLECT_CHUNKS if k < length] if chunk is None else [chunk]
        plans = [p for te in tes for kx in kxs
                 if (p := _collect_layout(length, (h1, h2), n, m, view, n_stacks, True, te,
                                          False, kx))]
        if plans:
            return next((p for p in plans if p.blocks_per_sm >= 2), plans[0])
    raise ValueError("observation too long for the collector's shared memory")


def _obs_args(config: WarehouseConfig) -> list:
    """The collector kernels' observation arguments: sensor range, normalised
    coordinates, then the image mode's (K2e) layer table packed four bits a
    channel, its channel count (0: FLATTENED), directional flag and IMAGE_DICT
    self rows."""
    layers = config.image_observation_layers if config.observation_type in IMAGE_TYPES else ()
    return [config.sensor_range, int(config.normalised_coordinates),
            sum(int(layer) << (4 * c) for c, layer in enumerate(layers)), len(layers),
            int(config.image_observation_directional),
            int(config.observation_type == ObservationType.IMAGE_DICT)]


class _Collector:
    """What the fused collectors share: the config checks, the plain engine,
    the trajectory buffers.

    Every observation family is taken: FLATTENED and DICT as the FLATTENED
    vector, IMAGE and IMAGE_DICT (K2e) as the flat ``policy_obs_length``
    vector of :func:`~rware_tpu_torch.core.engine.build_policy_obs_fn`."""

    def __init__(self, config: WarehouseConfig, n_steps: int, hidden: Tuple[int, int],
                 deterministic: bool, what: str):
        _check_config(config)
        if config.observation_type in IMAGE_TYPES \
                and not 0 < len(config.image_observation_layers) <= MAX_LAYERS:
            raise ValueError(f"the fused collector takes 1 to {MAX_LAYERS} image layers")
        if len(hidden) != 2 or any(h % 8 for h in hidden):
            raise ValueError(f"the fused collector takes {what}, multiples of 8")
        self.config = config
        self.n_steps = n_steps
        self.hidden = tuple(hidden)
        self.deterministic = deterministic
        self.obs_len = config.policy_obs_length
        self.launches = 0
        self._obs = build_policy_obs_fn(config)
        self._transition = build_transition_fn(config)
        self._reset = build_reset_fn(config)
        self._layouts: Dict[torch.device, torch.Tensor] = {}

    def _layout(self, dev) -> torch.Tensor:
        if dev not in self._layouts:
            self._layouts[dev] = layout_buffer(self.config, dev)
        return self._layouts[dev]

    @property
    def traj_keys(self) -> Tuple[str, ...]:
        return TRAJ_KEYS + (("bits",) if self.config.msg_bits else ())

    def _empty_traj(self, b: int, dev) -> Dict[str, torch.Tensor]:
        t_len, n, m = self.n_steps, self.config.n_agents, self.config.msg_bits
        traj = {
            "obs": torch.empty((t_len, b, n, self.obs_len), dtype=torch.bfloat16, device=dev),
            "action": torch.empty((t_len, b, n), dtype=torch.int32, device=dev),
            "logp": torch.empty((t_len, b, n), dtype=torch.float32, device=dev),
            "value": torch.empty((t_len, b, n), dtype=torch.float32, device=dev),
            "reward": torch.empty((t_len, b, n), dtype=torch.float32, device=dev),
            "done": torch.empty((t_len, b), dtype=torch.bool, device=dev),
        }
        if m:
            traj["bits"] = torch.empty((t_len, b, n, m), dtype=torch.int32, device=dev)
        return traj

    def _sample(self, draws, t: int, logits, msg_logits):
        """(actions for the engine, action, bits or None, logp) of one step:
        the Gumbel move and, with message bits, the Bernoulli bits, their
        log-probability added to the move's."""
        b, n = logits.shape[:2]
        u = None
        if not self.deterministic:
            u = philox.gumbel_uniform(draws(t, philox.ACTION, n * 5).reshape(b, n, 5))
        action, logp = sample_action(logits, u)
        if msg_logits is None:
            return action, action, None, logp
        um = None
        if not self.deterministic:
            um = philox.gumbel_uniform(draws.message(t).reshape(b, n, -1))
        bits, logp_bits = sample_bernoulli(msg_logits, um)
        return torch.cat([action[..., None], bits], dim=-1), action, bits, logp + logp_bits

    def _traj_ptrs(self, traj) -> list:
        """The trajectory outputs in the kernels' argument order; no bits
        without message bits."""
        return [_ptr(traj.get(k)) for k in ("obs", "action", "bits", "logp", "value", "reward",
                                             "done")]


class FusedCollect(_Collector):
    """``collect(state, policy, seed, env_offset=0) -> (state, traj)``; see
    :func:`build_fused_collect`."""

    n_stacks = 1  # weight stacks the kernel takes: one network for all agents

    def __init__(self, config: WarehouseConfig, n_steps: int,
                 hidden: Tuple[int, int] = (128, 128), deterministic: bool = False):
        super().__init__(config, n_steps, hidden, deterministic, "two hidden layers")
        self.plan = collect_plan(config, self.hidden, self.n_stacks)

    @property
    def threads(self) -> int:
        return self.plan.threads

    @property
    def weights_global(self) -> bool:
        """True where the weights are read from device memory, not held in
        shared memory."""
        return self.plan.weights_global

    def _check_policy(self, policy: ActorCritic):
        m = self.config.msg_bits
        if policy.hidden != self.hidden or policy.obs_dim != self.obs_len \
                or policy.n_actions != 5 or policy.msg_bits != m:
            raise ValueError(
                f"policy must be ActorCritic(obs_dim={self.obs_len}, n_actions=5, "
                f"hidden={self.hidden}, msg_bits={m})"
            )

    def _forward(self, policy, obs: torch.Tensor):
        """(logits (B, N, A), value (B, N), msg_logits (B, N, M) or None) of
        the observations (B, N, L)."""
        return policy.heads(obs)

    def weights(self, policy, dev) -> list:
        """The kernel's ten weight arrays: dense_0 and dense_1 as (in, out) in
        bf16, their biases and the heads (policy, value, message) in f32;
        without message bits the message head is empty."""
        d0, d1 = policy.dense
        heads = [policy.policy, policy.value]
        if policy.msg_bits:
            heads.append(policy.message)
        out = [
            d0.weight.t().to(device=dev, dtype=torch.bfloat16).contiguous(),
            d0.bias.to(device=dev, dtype=torch.float32).contiguous(),
            d1.weight.t().to(device=dev, dtype=torch.bfloat16).contiguous(),
            d1.bias.to(device=dev, dtype=torch.float32).contiguous(),
        ]
        for layer in heads:
            out += [layer.weight.to(device=dev, dtype=torch.float32).contiguous(),
                    layer.bias.to(device=dev, dtype=torch.float32).contiguous()]
        if not policy.msg_bits:
            out += [torch.empty(0, device=dev), torch.empty(0, device=dev)]
        return out

    def __call__(self, state: WarehouseState, policy, seed, env_offset: int = 0):
        _check_state(self.config, state)
        self._check_policy(policy)
        seed = _check_seed(seed)
        env_offset = _check_env_offset(env_offset, state.batch_size)
        if state.device.type == "cuda":
            return self._launch(state, policy, seed, env_offset)
        if state.device.type == "cpu":
            return self.plain(state, policy, seed, env_offset)
        raise ValueError(f"no fused collector for device {state.device}")

    @torch.no_grad()
    def plain(self, state: WarehouseState, policy, seed, env_offset: int = 0):
        """The plain PyTorch version: observe -> ActorCritic -> sample ->
        step, with the kernel's draws."""
        self._check_policy(policy)
        seed = _check_seed(seed)
        b = state.batch_size
        draws = _Draws(self.config, seed, self.deterministic, b, state.device, env_offset)
        out = {k: [] for k in self.traj_keys}
        for t in range(self.n_steps):
            obs = self._obs(state).to(torch.bfloat16)
            logits, value, msg_logits = self._forward(policy, obs)
            acts, action, bits, logp = self._sample(draws, t, logits, msg_logits)
            state, rewards, done, _ = self._transition(state, acts, draws.queue(t))
            state = self._reset(draws.respawn(t)).where(done, state)
            for k, v in zip(out, (obs, action, logp, value, rewards, done, bits)):
                out[k].append(v)
        return state, {k: torch.stack(v) for k, v in out.items()}

    @torch.no_grad()
    def _launch(self, state, policy, seed, env_offset):
        from rware_tpu_torch.ops._build import check, load_library

        lib = load_library()
        dev = state.device
        b, t_len, l_obs = state.batch_size, self.n_steps, self.obs_len
        h1, h2 = self.hidden
        with torch.cuda.device(dev):
            packed = pack_state(state)
            out = torch.empty_like(packed)
            weights = self.weights(policy, dev)
            traj = self._empty_traj(b, dev)
            plan = self.plan.args()
            plan_buf = (ctypes.c_int * len(plan))(*plan)
            code = lib.rw_fused_collect(
                *_dims(self.config), seed, env_offset, int(self.deterministic), t_len, b,
                *_obs_args(self.config), l_obs, h1, h2, 5, self.n_stacks,
                ctypes.addressof(plan_buf), len(plan),
                _ptr(self._layout(dev)), _ptr(packed), _ptr(out),
                *[_ptr(w) for w in weights], *self._traj_ptrs(traj),
                torch.cuda.current_stream(dev).cuda_stream,
            )
            check(lib, code, "fused_collect")
            self.launches += 1
        return unpack_state(out, state), traj


def build_fused_collect(config: WarehouseConfig, n_steps: int,
                        hidden: Tuple[int, int] = (128, 128),
                        deterministic: bool = False) -> FusedCollect:
    """Returns ``collect(state, policy, seed, env_offset=0) -> (state, traj)`` with ``traj``
    = obs (T, B, N, L) bf16; action (T, B, N) int32; logp, value, reward
    (T, B, N) f32; done (T, B) bool — the ``native_traj=False`` layout of
    ``pallas_rollout.py:1812-1815`` — and with message bits (``config.msg_bits``
    M > 0, K2b) bits (T, B, N, M) int32, logp then being the joint move + bits
    log-probability.  ``policy`` is an :class:`ActorCritic` with ``hidden``
    and the config's ``msg_bits``; ``deterministic`` takes the argmax action,
    the bits ``logit > 0`` and the scripted draws."""
    return FusedCollect(config, n_steps, hidden, deterministic)


class FusedCollectPerAgent(FusedCollect):
    """``collect(state, policies, seed, env_offset=0) -> (state, traj)``; see
    :func:`build_fused_collect_per_agent`.  K2a's wrapper with one weight
    stack per agent."""

    def __init__(self, config: WarehouseConfig, n_steps: int,
                 hidden: Tuple[int, int] = (128, 128), deterministic: bool = False):
        # all N networks in shared memory where they fit beside the tile (up
        # to 3 agents at L=71, hidden (128, 128)); else read from device memory
        self.n_stacks = config.n_agents
        super().__init__(config, n_steps, hidden, deterministic)

    def _check_policy(self, policies: Sequence[ActorCritic]):
        n, m = self.config.n_agents, self.config.msg_bits
        if len(policies) != n or any(
                p.hidden != self.hidden or p.obs_dim != self.obs_len or p.n_actions != 5
                or p.msg_bits != m for p in policies):
            raise ValueError(
                f"policies must be {n} ActorCritic(obs_dim={self.obs_len}, n_actions=5, "
                f"hidden={self.hidden}, msg_bits={m}), one per agent"
            )

    def _forward(self, policies, obs: torch.Tensor):
        """Agent i's network on agent i's observation, the agents stacked
        (:func:`stacked_heads`)."""
        logits, value, msg = stacked_heads(policies, obs.transpose(0, 1))
        return (logits.transpose(0, 1), value.transpose(0, 1),
                None if msg is None else msg.transpose(0, 1))

    def weights(self, policies, dev) -> list:
        """The kernel's ten weight arrays, each the agents' stacks back to
        back: dense_0 and dense_1 as (in, out) in bf16, the heads and biases in
        f32 (the message head empty without message bits)."""
        per_agent = [super(FusedCollectPerAgent, self).weights(p, dev) for p in policies]
        return [torch.stack([w[k] for w in per_agent]).contiguous() for k in range(10)]


def build_fused_collect_per_agent(config: WarehouseConfig, n_steps: int,
                                  hidden: Tuple[int, int] = (128, 128),
                                  deterministic: bool = False) -> FusedCollectPerAgent:
    """Returns ``collect(state, policies, seed, env_offset=0) -> (state, traj)`` with
    ``policies`` a sequence of N :class:`ActorCritic` with ``hidden`` and the
    config's ``msg_bits``, agent i running ``policies[i]``
    (``pallas_rollout.py:1316-1373``), and ``traj`` as
    :func:`build_fused_collect`'s, bits included with message bits."""
    return FusedCollectPerAgent(config, n_steps, hidden, deterministic)


# The regions of a recurrent-collector block's shared memory, in order (csrc/
# collect_gru.cuh): the f32 be, bi, bhn, Wc and bc of the stacks held there
# (empty where they are read from device memory), the observation tile (the
# embedding written over it; ``kx`` features of it where the plan chunks it),
# the embedding (empty unless the observation is chunked), the carry tile (new
# h written over it), the weight ring, a record a row, a view an env, done an
# env.
COLLECT_GRU_REGIONS = ("be", "bi", "bhn", "wc", "bc", "x", "e", "h", "ring", "out", "view",
                       "done")
COLLECT_GRU_THREADS = 256  # two blocks an SM at 128 registers a thread
COLLECT_GRU_MIN_BLOCKS = 128  # about a block for each of the card's 132 SMs
COLLECT_GRU_MAX_WIDTH = 8 * COLLECT_GRU_THREADS  # an output group of 8 a thread
COLLECT_GRU_RT = 4  # rows of a thread's register tile
COLLECT_GRU_KCS = (32, 16, 8, 4, 2, 1)  # weight rows a chunk of the ring, longest first
COLLECT_GRU_RING = 24576  # bytes the ring's three chunks may take, unless one row of each is more


@dataclasses.dataclass(frozen=True)
class GruCollectPlan(CollectPlan):
    """The launch plan of the recurrent collector (K2c, K2d′ and their message
    and image modes), in :class:`CollectPlan`'s fields: ``te`` envs a block,
    ``threads``, ``rows`` (N x te, agent-major, padded to 8) and their stride
    ``rs``, ``hrs`` and ``vs``, ``weights_global`` true where the f32 bias and
    head blocks are read from device memory (We, Wi and Wh always are, through
    a ring of three chunks of ``kc`` weight rows for ``ring_stacks`` stacks in
    shared memory), the byte offsets of :data:`COLLECT_GRU_REGIONS` with
    their end, and ``kx``, the observation features a chunk of the tile holds
    (0: the whole row).  ``args`` is what ``rw_fused_collect_gru`` takes,
    which refuses a plan whose regions do not hold what the kernel keeps
    there."""

    kc: int = 32
    ring_stacks: int = 1

    regions = COLLECT_GRU_REGIONS

    @property
    def heads_global(self) -> bool:
        return self.weights_global

    def args(self) -> list:
        return [self.te, self.threads, self.rows, self.rs, self.hrs, self.vs,
                int(self.weights_global), self.carveout, self.kc, self.ring_stacks, self.kx,
                *self.offsets]


def _set_stacks(rows: int, cols: int, threads: int, te: int) -> int:
    """The most stacks one set of a product's rows spans (K2d′: row r runs
    stack r // te): sets of as many 4-row groups as give every job of 8
    output columns a thread (csrc/collect_gru.cuh RowSet)."""
    nrg = rows // COLLECT_GRU_RT
    rgs = min(nrg, threads // (cols // 8))
    return max((min(rg0 + rgs, nrg) * COLLECT_GRU_RT - 1) // te - rg0 * COLLECT_GRU_RT // te + 1
               for rg0 in range(0, nrg, rgs))


def _gru_admitted(length: int, hidden: Sequence[int], msg_bits: int, n_stacks: int) -> bool:
    """The admission rule of the one-thread-per-env kernel before this plan
    (32 threads at least, each thread's observation, embedding and hidden a
    column of the tiles, one stack's f32 blocks beside them, or for several
    stacks none): the plan refuses what it refused."""
    embed, hg = hidden
    heads = 6 + msg_bits
    f32 = (embed + 4 * hg + hg * heads + heads) if n_stacks == 1 else 0
    return _up(4 * f32, 16) + 2 * (length + embed + hg) * 32 <= SMEM_LIMIT


def _gru_layout(length: int, hidden: Sequence[int], n_agents: int, msg_bits: int, view: int,
                n_stacks: int, heads_global: bool, te: int, kc: int,
                kx: int = 0) -> Optional[GruCollectPlan]:
    """The plan of tile ``te`` with ring chunks of ``kc`` weight rows (and
    ``kx`` > 0: the observation tile in chunks of ``kx`` features, a multiple
    of ``kc``, the embedding in a region of its own), or None where it does
    not fit a block."""
    embed, hg = hidden
    rows = _up(n_agents * te, 8)
    heads = 5 + 1 + msg_bits
    threads = _up(max(COLLECT_GRU_THREADS, rows + 32), 32)
    if threads > COLLECT_MAX_THREADS or kx % kc:
        return None
    ws = 0 if heads_global else n_stacks
    stacks = 1 if n_stacks == 1 else max(_set_stacks(rows, c, threads, te) for c in hidden)
    if kc > max(1, COLLECT_GRU_RING // (3 * stacks * max(hidden) * 2)):
        return None
    sizes = [ws * embed * 4, ws * 3 * hg * 4, ws * hg * 4, ws * hg * heads * 4, ws * heads * 4,
             (kx or max(length, embed)) * rows * 2, embed * rows * 2 if kx else 0,
             hg * rows * 2, 3 * stacks * kc * max(hidden) * 2,
             rows * (heads | 1) * 4, te * (view | 1) * 4, te]
    offsets = [0]
    for size in sizes:
        offsets.append(offsets[-1] + _up(size, 16))
    if offsets[-1] > SMEM_LIMIT:
        return None
    return GruCollectPlan(te, threads, rows, rows, heads | 1, view | 1, heads_global,
                          tuple(offsets), kx, kc, stacks)


def collect_gru_plan(config: WarehouseConfig, hidden: Sequence[int], n_stacks: int = 1,
                     batch: int = 16384, heads_global: Optional[bool] = None,
                     chunk: Optional[int] = None) -> GruCollectPlan:
    """The recurrent collector's plan for ``config`` (its observation length,
    agents and message bits), ``hidden`` = (embed, GRU width), ``n_stacks``
    weight stacks (1: K2c, N: K2d′) and ``batch`` envs.  The tile aims at
    :data:`COLLECT_ROWS` rows, and shrinks until ``batch`` envs give
    :data:`COLLECT_GRU_MIN_BLOCKS` blocks, down to :data:`COLLECT_MIN_ROWS`
    rows (K2c) or 8 envs (K2d′, whose 4-row groups each run one agent's
    stack); from there, the largest tile that keeps two blocks an SM, else
    the largest that fits a block.  The f32 bias and head blocks of the
    stacks are held in shared memory unless that costs the tile a block an SM
    (or ``heads_global`` says which), after the weight ring has taken the
    longest chunks of :data:`COLLECT_GRU_KCS` that cost it none.  Where no
    tile holds the whole observation (K2d′ at 16 agents and sensor range 5),
    K2d′ builds and embeds it in chunks of :data:`COLLECT_CHUNKS` features,
    the embedding in a region of its own, by the same rules with the longest
    chunk after the ring's; ``chunk`` 0 asks for the whole tile, a length for
    that chunk.  Raises ``ValueError`` where the kernel before this plan
    refused (:func:`_gru_admitted`) or no tile fits, and for widths above
    :data:`COLLECT_GRU_MAX_WIDTH`."""
    embed, hg = hidden
    n, m, length = config.n_agents, config.msg_bits, config.policy_obs_length
    if max(embed, hg) > COLLECT_GRU_MAX_WIDTH:
        raise ValueError(f"the recurrent collector takes widths up to {COLLECT_GRU_MAX_WIDTH}")
    layout = config.compile_layout()
    if layout.grid_size[0] * layout.grid_size[1] > 65536:
        raise ValueError("the collector's env view takes grids of at most 65,536 cells")
    if not _gru_admitted(length, hidden, m, n_stacks):
        raise ValueError("observation too long for the collector's shared memory")
    view = 2 * n + n * m + config.request_queue_size + layout.n_shelves
    step = 8 if n_stacks > 1 else 1
    te_max = max(step, COLLECT_ROWS // n // step * step)
    te_min = step if n_stacks > 1 else min(te_max, -(-COLLECT_MIN_ROWS // n))
    te_batch = next((te for te in range(te_max, te_min - 1, -step)
                     if -(-batch // te) >= COLLECT_GRU_MIN_BLOCKS), te_min)
    routes = (False, True) if heads_global is None else (bool(heads_global),)
    # the whole tile first; the chunked route (K2d′'s instantiations) only
    # where no tile holds it
    chunked = [k for k in COLLECT_CHUNKS if k < length] if chunk is None else [chunk]
    for chunks in ([0] if not chunk else [], chunked if n_stacks > 1 and chunk != 0 else []):
        largest = None
        for te in range(te_batch, 0, -step) if chunks else ():
            fits = [p for glob in routes for kc in COLLECT_GRU_KCS for kx in chunks
                    if (p := _gru_layout(length, hidden, n, m, view, n_stacks, glob, te, kc, kx))]
            if not fits:
                continue
            # the longest chunks, then the f32 blocks in shared memory, that
            # cost the tile no block an SM
            plan = max(fits, key=lambda p: (p.blocks_per_sm, p.kc, p.kx, not p.heads_global))
            if plan.blocks_per_sm >= 2 and te >= te_min:
                return plan
            largest = largest or plan
        if largest is not None:
            return largest
    raise ValueError("observation too long for the collector's shared memory")


class FusedCollectGru(_Collector):
    """``collect(state, policy, seed, h0, env_offset=0) -> (state, new_h, traj)``; see
    :func:`build_fused_collect_gru`.  ``heads_global`` (None: the plan's
    choice) forces the f32 bias and head blocks into device memory (True) or
    shared memory (False); :meth:`plan` gives a batch's launch plan."""

    n_stacks = 1  # weight stacks the kernel takes: one GRU for all agents
    kernel_name = "fused_collect_gru"

    def __init__(self, config: WarehouseConfig, n_steps: int, hidden: Tuple[int, int] = (128, 128),
                 deterministic: bool = False):
        super().__init__(config, n_steps, hidden, deterministic, "(embed, gru_hidden)")
        self.heads_global: Optional[bool] = None
        self.plan(1)  # raises where no tile fits

    def plan(self, batch: int) -> GruCollectPlan:
        """The launch plan for ``batch`` envs (:func:`collect_gru_plan`)."""
        return collect_gru_plan(self.config, self.hidden, self.n_stacks, batch, self.heads_global)

    def _check_net(self, policy) -> bool:
        return isinstance(policy, RecurrentActorCritic) and policy.obs_dim == self.obs_len \
            and (policy.embed_dim, policy.hidden) == self.hidden and policy.n_actions == 5 \
            and policy.msg_bits == self.config.msg_bits

    def _check_policy(self, policy: RecurrentActorCritic):
        if not self._check_net(policy):
            raise ValueError(
                f"policy must be RecurrentActorCritic(obs_dim={self.obs_len}, n_actions=5, "
                f"hidden={self.hidden[1]}, embed={self.hidden[0]}, "
                f"msg_bits={self.config.msg_bits})"
            )

    def _check(self, state: WarehouseState, policy, h0: torch.Tensor):
        _check_state(self.config, state)
        self._check_policy(policy)
        want = (state.batch_size, self.config.n_agents, self.hidden[1])
        if tuple(h0.shape) != want or h0.dtype != torch.bfloat16 or h0.device != state.device:
            raise ValueError(f"h0 must be bf16 {want} on {state.device}")

    def _arrays(self, policy, dev) -> list:
        """The eight :class:`GruDims` blocks of ``policy`` on ``dev``."""
        return [a.detach().to(dev) for a in gru_to_arrays(policy)]

    def _cell(self, arrays, h: torch.Tensor, obs: torch.Tensor):
        """(logits (B, N, A), value (B, N), msg_logits (B, N, M) or None, new
        h (B, N, Hg)) of one step of the collector-rounding cell on the carry
        ``h`` and the observations ``obs`` (B, N, L)."""
        b, n, hg = h.shape
        m = self.config.msg_bits
        heads, value, new_h = gru_collect_step(arrays, h.reshape(b * n, hg),
                                               obs.reshape(b * n, -1), m)
        logits, msg_logits = heads if m else (heads, None)
        return (logits.reshape(b, n, -1), value.reshape(b, n),
                None if msg_logits is None else msg_logits.reshape(b, n, m),
                new_h.reshape(b, n, hg))

    def __call__(self, state: WarehouseState, policy, seed, h0: torch.Tensor,
                 env_offset: int = 0):
        self._check(state, policy, h0)
        seed = _check_seed(seed)
        env_offset = _check_env_offset(env_offset, state.batch_size)
        if state.device.type == "cuda":
            return self._launch(state, policy, seed, h0, env_offset)
        if state.device.type == "cpu":
            return self.plain(state, policy, seed, h0, env_offset)
        raise ValueError(f"no fused collector for device {state.device}")

    @torch.no_grad()
    def plain(self, state: WarehouseState, policy, seed, h0: torch.Tensor, env_offset: int = 0):
        """The plain PyTorch version: observe -> the collector-rounding cell
        (:func:`gru_collect_step`) -> sample -> step, with the kernel's
        draws; the carry is zeroed where an episode ends."""
        self._check(state, policy, h0)
        seed = _check_seed(seed)
        draws = _Draws(self.config, seed, self.deterministic, state.batch_size, state.device,
                       env_offset)
        arrays = self._arrays(policy, state.device)
        h = h0.to(torch.float32)
        out = {k: [] for k in self.traj_keys}
        for t in range(self.n_steps):
            obs = self._obs(state).to(torch.bfloat16)
            logits, value, msg_logits, h = self._cell(arrays, h, obs)
            acts, action, bits, logp = self._sample(draws, t, logits, msg_logits)
            state, rewards, done, _ = self._transition(state, acts, draws.queue(t))
            state = self._reset(draws.respawn(t)).where(done, state)
            h = torch.where(done[:, None, None], torch.zeros_like(h), h)
            for k, v in zip(out, (obs, action, logp, value, rewards, done, bits)):
                out[k].append(v)
        return state, h.to(torch.bfloat16), {k: torch.stack(v) for k, v in out.items()}

    def weights(self, policy, dev) -> list:
        """The kernel's eight weight arrays: We, Wi, Wh in bf16, the biases
        and the head block in f32."""
        we, be, wi, bi, wh, bhn, wc, bc = self._arrays(policy, dev)
        return [
            we.to(torch.bfloat16).contiguous(), be.float().contiguous(),
            wi.to(torch.bfloat16).contiguous(), bi.float().contiguous(),
            wh.to(torch.bfloat16).contiguous(), bhn.float().contiguous(),
            wc.float().contiguous(), bc.float().contiguous(),
        ]

    @torch.no_grad()
    def _launch(self, state, policy, seed, h0, env_offset):
        from rware_tpu_torch.ops._build import check, load_library

        lib = load_library()
        dev = state.device
        b, t_len, l_obs = state.batch_size, self.n_steps, self.obs_len
        embed, hg = self.hidden
        with torch.cuda.device(dev):
            packed = pack_state(state)
            out = torch.empty_like(packed)
            weights = self.weights(policy, dev)
            h0 = h0.contiguous()
            new_h = torch.empty_like(h0)
            traj = self._empty_traj(b, dev)
            plan = self.plan(b).args()
            plan_buf = (ctypes.c_int * len(plan))(*plan)
            code = lib.rw_fused_collect_gru(
                *_dims(self.config), seed, env_offset, int(self.deterministic), t_len, b,
                *_obs_args(self.config), l_obs, embed, hg, 5, self.n_stacks,
                ctypes.addressof(plan_buf), len(plan),
                _ptr(self._layout(dev)), _ptr(packed), _ptr(out),
                *[_ptr(w) for w in weights], _ptr(h0), _ptr(new_h), *self._traj_ptrs(traj),
                torch.cuda.current_stream(dev).cuda_stream,
            )
            check(lib, code, self.kernel_name)
            self.launches += 1
        return unpack_state(out, state), new_h, traj


def build_fused_collect_gru(config: WarehouseConfig, n_steps: int,
                            hidden: Tuple[int, int] = (128, 128),
                            deterministic: bool = False) -> FusedCollectGru:
    """Returns ``collect(state, policy, seed, h0, env_offset=0) -> (state, new_h, traj)``:
    ``policy`` is a :class:`RecurrentActorCritic` with ``hidden`` = (embed,
    gru_hidden), ``h0`` and ``new_h`` the (B, N, Hg) bf16 carry before and
    after the rollout (zero after an episode's last step), ``traj`` as
    :func:`build_fused_collect`'s, bits included with message bits
    (``pallas_rollout.py:1832-1836``)."""
    return FusedCollectGru(config, n_steps, hidden, deterministic)


class FusedCollectGruPerAgent(FusedCollectGru):
    """``collect(state, policies, seed, h0, env_offset=0) -> (state, new_h, traj)``; see
    :func:`build_fused_collect_gru_per_agent`.  K2c's wrapper with one weight
    stack per agent (K2d′)."""

    kernel_name = "fused_collect_gru_per_agent"

    def __init__(self, config: WarehouseConfig, n_steps: int, hidden: Tuple[int, int] = (128, 128),
                 deterministic: bool = False):
        self.n_stacks = config.n_agents
        super().__init__(config, n_steps, hidden, deterministic)

    def _check_policy(self, policies: Sequence[RecurrentActorCritic]):
        n = self.config.n_agents
        if len(policies) != n or not all(self._check_net(p) for p in policies):
            raise ValueError(
                f"policies must be {n} RecurrentActorCritic(obs_dim={self.obs_len}, "
                f"n_actions=5, hidden={self.hidden[1]}, embed={self.hidden[0]}, "
                f"msg_bits={self.config.msg_bits}), one per agent"
            )

    def _arrays(self, policies, dev) -> list:
        """The eight :class:`GruDims` blocks, each the agents' stacked on a
        leading axis."""
        per_agent = [super(FusedCollectGruPerAgent, self)._arrays(p, dev) for p in policies]
        return [torch.stack(blocks) for blocks in zip(*per_agent)]

    def _cell(self, arrays, h: torch.Tensor, obs: torch.Tensor):
        """Agent i's cell (``_gru_forward_per_agent``) on agent i's slice of
        the carry and agent i's observation, the agents' stacks run at once
        (:func:`gru_collect_step` on a leading agent axis)."""
        m = self.config.msg_bits
        heads, value, new_h = gru_collect_step(arrays, h.transpose(0, 1), obs.transpose(0, 1), m)
        logits, msg = heads if m else (heads, None)
        return (logits.transpose(0, 1), value.transpose(0, 1),
                None if msg is None else msg.transpose(0, 1), new_h.transpose(0, 1))


def build_fused_collect_gru_per_agent(config: WarehouseConfig, n_steps: int,
                                      hidden: Tuple[int, int] = (128, 128),
                                      deterministic: bool = False) -> FusedCollectGruPerAgent:
    """Returns ``collect(state, policies, seed, h0, env_offset=0) -> (state, new_h, traj)``
    with ``policies`` a sequence of N :class:`RecurrentActorCritic` with
    ``hidden`` = (embed, gru_hidden) and the config's ``msg_bits``, agent i
    running ``policies[i]`` on its own slice ``h0[:, i]`` of the carry
    (``pallas_rollout.py:1376-1435``); ``new_h`` and ``traj`` as
    :func:`build_fused_collect_gru`'s."""
    return FusedCollectGruPerAgent(config, n_steps, hidden, deterministic)
