"""State-injection helpers (the counterpart of ``rware_tpu/testing.py``).

:func:`make_state` builds an exact one-env state (B = 1) for a test scenario,
with shelves at their home slots unless overridden — the functional form of
the reference's "mutate agents and shelves, then ``_recalc_grid()``" test
pattern (reference tests/test_movement.py:14-61).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.core.state import WarehouseState
from rware_tpu_torch.types import Direction


def make_state(
    config: WarehouseConfig,
    agents: Sequence[Tuple],
    *,
    shelves: Optional[Sequence[Tuple[int, int]]] = None,
    queue: Optional[Sequence[int]] = None,
    carrying: Optional[Sequence[int]] = None,
    has_delivered: Optional[Sequence[bool]] = None,
    agent_message: Optional[Sequence[Sequence[float]]] = None,
    device="cpu",
) -> WarehouseState:
    """Build a one-env WarehouseState for a test scenario.

    Args:
      config: static env config (must match the lengths given here).
      agents: per-agent ``(x, y, direction)`` tuples.
      shelves: optional per-shelf ``(x, y)``; defaults to home rack slots.
      queue: optional request-queue shelf indices (0-based); defaults to
        ``[0, 1, ..., R-1]``.
      carrying: optional per-agent carried shelf index or -1.
      has_delivered: optional per-agent TWO_STAGE delivery flags.
      agent_message: optional per-agent message bits (N lists of msg_bits
        values); zeros by default.
      device: where the state's tensors live.
    """
    layout = config.compile_layout()
    n = config.n_agents
    if len(agents) != n:
        raise ValueError(f"need {n} agent tuples, got {len(agents)}")

    def ints(values):
        return torch.tensor([list(values)], dtype=torch.int32, device=device)

    ax = ints(a[0] for a in agents)
    ay = ints(a[1] for a in agents)
    adir = ints(int(a[2]) for a in agents)
    if shelves is None:
        sx = ints(layout.shelf_slots[:, 0].tolist())
        sy = ints(layout.shelf_slots[:, 1].tolist())
    else:
        if len(shelves) != layout.n_shelves:
            raise ValueError(
                f"need {layout.n_shelves} shelf positions, got {len(shelves)}"
            )
        sx = ints(s[0] for s in shelves)
        sy = ints(s[1] for s in shelves)
    if queue is None:
        queue = range(config.request_queue_size)
    if carrying is None:
        carrying = [-1] * n
    if has_delivered is None:
        has_delivered = [False] * n

    # Carried shelves ride on their carrier (reference invariant).
    for i, c in enumerate(carrying):
        if c >= 0:
            sx[0, c] = ax[0, i]
            sy[0, c] = ay[0, i]

    zero = torch.zeros(1, dtype=torch.int32, device=device)
    return WarehouseState(
        agent_x=ax,
        agent_y=ay,
        agent_dir=adir,
        agent_carrying=ints(carrying),
        agent_has_delivered=torch.tensor(
            [list(has_delivered)], dtype=torch.bool, device=device
        ),
        agent_message=(
            torch.zeros((1, n, config.msg_bits), dtype=torch.float32, device=device)
            if agent_message is None
            else torch.tensor([list(map(list, agent_message))], dtype=torch.float32,
                              device=device).reshape(1, n, config.msg_bits)
        ),
        shelf_x=sx,
        shelf_y=sy,
        request_queue=ints(queue).reshape(1, -1),
        cur_steps=zero.clone(),
        cur_inactive_steps=zero.clone(),
    )


def random_ppo_case(env_id: str, n_envs: int, t_full: int, seed: int = 0, device="cpu",
                    msg_bits: int = 0, hidden: Tuple[int, int] = (128, 128)):
    """``(dims, params, data)`` of random inputs for the PPO kernels at
    ``env_id``'s observation length and agent count: flax-initialised
    parameters at ``hidden``, and a ``(T, B, N, ...)`` trajectory of
    bf16 0/1 features, actions, logp near log(1/5), and normal values,
    advantages and targets (``torch.Generator`` seeded on ``device``).  With
    ``msg_bits`` M the net has a message head, logp is near log(1/5) + M
    log(1/2) and a 7th entry holds random bits (T, B, N, M) int32."""
    import dataclasses

    from rware_tpu_torch.models.networks import (
        BlockDims,
        init_actor_critic,
        pack_arrays,
        params_to_arrays,
    )
    from rware_tpu_torch.registry import parse_env_id

    cfg = dataclasses.replace(parse_env_id(env_id), msg_bits=msg_bits)
    l_obs, shape = cfg.policy_obs_length, (t_full, n_envs, cfg.n_agents)
    model = init_actor_critic(l_obs, 5, hidden, seed, msg_bits)
    params = pack_arrays(params_to_arrays(model)).detach().to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    data = (
        (torch.rand(shape + (l_obs,), generator=gen, device=device) < 0.3).to(torch.bfloat16),
        torch.randint(0, 5, shape, generator=gen, device=device, dtype=torch.int32),
        torch.randn(shape, generator=gen, device=device) * 0.1 - 1.6 - 0.69 * msg_bits,
        *(torch.randn(shape, generator=gen, device=device) for _ in range(3)),
    )
    if msg_bits:
        data += (torch.randint(0, 2, shape + (msg_bits,), generator=gen, device=device,
                               dtype=torch.int32),)
    return BlockDims.of(model), params, data


def random_mappo_case(env_id: str, n_envs: int, t_full: int, seed: int = 0, device="cpu",
                      hidden: Tuple[int, int] = (128, 128)):
    """``(dims, cdims, params, data)``: :func:`random_ppo_case` plus a
    flax-initialised central critic, both at ``hidden``; ``params`` is the
    ``{"actor", "critic"}`` dict of flat vectors."""
    from rware_tpu_torch.models.networks import (
        CriticDims,
        critic_to_arrays,
        init_central_critic,
        pack_arrays,
    )

    dims, actor, data = random_ppo_case(env_id, n_envs, t_full, seed, device, hidden=hidden)
    n = data[1].shape[2]
    critic = init_central_critic(n * dims.obs_len, n, hidden, (seed, 1))
    params = {"actor": actor,
              "critic": pack_arrays(critic_to_arrays(critic)).detach().to(device)}
    return dims, CriticDims.of(critic), params, data


def random_seac_case(env_id: str, n_envs: int, t_full: int, seed: int = 0, device="cpu",
                     hidden: Tuple[int, int] = (128, 128)):
    """``(dims, params, data)`` of random inputs for SEAC-PPO's gradient
    kernel: the obs, actions and behaviour log-probs of
    :func:`random_ppo_case`, normal old values, advantages and targets as
    ``(N_i, T, B, N_j)`` cross arrays, and N independent flax-initialised
    networks at ``hidden`` stacked into ``(N, P)``, biases off zero."""
    from rware_tpu_torch.models.networks import init_actor_critic, pack_arrays, params_to_arrays

    dims, _, data = random_ppo_case(env_id, n_envs, t_full, seed, device, hidden=hidden)
    n = data[1].shape[2]
    params = torch.stack([
        pack_arrays(params_to_arrays(init_actor_critic(dims.obs_len, 5, hidden, (seed, 2, i))))
        for i in range(n)]).detach().to(device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for row in params:
        for block in dims.split(row):
            if block.shape[0] == 1:  # a bias
                block += 0.1 * torch.randn(block.shape, generator=gen, device=device)
    cross = tuple(torch.randn((n,) + tuple(data[1].shape), generator=gen, device=device)
                  for _ in range(3))
    return dims, params, data[:3] + cross


UP = Direction.UP
DOWN = Direction.DOWN
LEFT = Direction.LEFT
RIGHT = Direction.RIGHT


def random_gru_seq_case(env_id: str, n_envs: int, t_len: int, band: Tuple[int, int],
                        seed: int = 0, device="cpu", hidden: int = 128, embed: int = 128):
    """``(dims, args)`` of random inputs for the iall-fed GRU kernels (K11,
    K12, K13) on the env band ``band`` = (start_env, n_env) of a batch of
    ``n_envs`` at ``env_id``'s observation length and agent count: a
    flax-initialised recurrent actor with its biases moved off zero; ``iall``
    (T, n_env, N, 3Hg) bf16, the fused input gates of 0/0.5/1 observations
    (:func:`~rware_tpu_torch.models.networks.gru_embed_gates`); ``done`` (T,
    B) at 20%; a nonzero carry ``h0`` (B, N, Hg) bf16; the loss streams of
    :func:`random_ppo_case` (T, B, N) and the band's advantage ``stats``.
    ``args`` is a dict keyed by the kernels' argument names (``wh``, ``bhn``,
    ``whead``, ``bhead``, ``iall``, ``done``, ``h0``, ``action``, ``logp``,
    ``value``, ``adv``, ``target``, ``stats``)."""
    from rware_tpu_torch.models.networks import (
        GruDims,
        gru_embed_gates,
        gru_to_arrays,
        init_recurrent_actor_critic,
    )
    from rware_tpu_torch.ops.fused_gru import band_index
    from rware_tpu_torch.registry import parse_env_id

    cfg = parse_env_id(env_id)
    l_obs, n = cfg.policy_obs_length, cfg.n_agents
    model = init_recurrent_actor_critic(l_obs, 5, hidden, embed, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    arrays = [a.detach().to(device) for a in gru_to_arrays(model)]
    arrays = [a + 0.1 * torch.randn(a.shape, generator=gen, device=device) if a.shape[0] == 1
              else a for a in arrays]
    we, be, wi, bi, wh, bhn, wc, bc = arrays
    start, n_env = band
    obs = torch.randint(0, 3, (t_len, n_env, n, l_obs), generator=gen, device=device) * 0.5
    with torch.no_grad():
        iall = gru_embed_gates((we, be, wi, bi), obs)[1].to(torch.bfloat16)
    shape = (t_len, n_envs, n)
    adv = torch.randn(shape, generator=gen, device=device)
    advb = adv[:, band_index(start, n_env, n_envs, device)]
    args = dict(
        wh=wh, bhn=bhn, whead=wc, bhead=bc[0], iall=iall,
        done=torch.rand((t_len, n_envs), generator=gen, device=device) < 0.2,
        h0=(torch.rand((n_envs, n, hidden), generator=gen, device=device) * 2 - 1
            ).to(torch.bfloat16),
        action=torch.randint(0, 5, shape, generator=gen, device=device, dtype=torch.int32),
        logp=torch.randn(shape, generator=gen, device=device) * 0.1 - 1.6,
        value=torch.randn(shape, generator=gen, device=device), adv=adv,
        target=torch.randn(shape, generator=gen, device=device),
        stats=torch.stack([advb.mean(), 1.0 / (advb.std(correction=0) + 1e-8)]),
    )
    return GruDims.of(model), args


def positions(state: WarehouseState, env: int = 0) -> list:
    """[(x, y), ...] per agent of one env — concise assertion helper."""
    return list(zip(state.agent_x[env].tolist(), state.agent_y[env].tolist()))
