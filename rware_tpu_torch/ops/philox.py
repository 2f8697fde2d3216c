"""Philox4x32-10 in plain torch, and the draw formulas of the fused kernels.

The TPU kernels draw from the chip's own generator
(``pltpu.prng_random_bits``, ``rware_tpu/ops/pallas_rollout.py:70-110``),
which nothing else can reproduce.  The port draws every random number from
Philox4x32-10 (Salmon et al., SC'11), a counter-based generator: a draw is a
pure function of ``(seed, counter)``, so the CUDA kernels
(``csrc/env_core.cuh`` holds the same function) and this plain version give
the same bits for the same draw, in any order and on any device.

Counter layout, one 128-bit counter per group of four draws::

    (env, step, purpose, slot // 4) -> word slot % 4

``env`` is the env's global index: its index in the launch's batch plus the
launch's ``env_offset`` (a shard of rows ``[o, o + b)`` of a global batch,
launched with ``env_offset = o``, draws what those rows of the global launch
draw); ``step`` the step within one call,
``purpose`` one of the constants below and ``slot`` the draw's index within
that purpose.  The key is the 64-bit ``seed``.

Torch has no uint32 arithmetic, so words are held in int64 tensors and the
32x32-bit products are split into 16-bit halves (a full product would
overflow int64 for Philox's multipliers).
"""
from __future__ import annotations

import torch

M0 = 0xD2511F53
M1 = 0xCD9E8D57
W0 = 0x9E3779B9
W1 = 0xBB67AE85
MASK32 = 0xFFFFFFFF

# Draw purposes (the third counter word).
ACTION = 0  # random actions (K1) and Gumbel uniforms (K2a): slot i*5 + a
QUEUE = 1  # request-queue resample: slot = goal index
RESPAWN = 2  # autoreset: slots [cells (N) | dirs (N) | queue (R)]
RESET = 3  # batched_reset at step 0, same slot layout as RESPAWN
MESSAGE = 4  # message bits (K1's random bits, K2b's Bernoulli uniforms): slot i*M + m


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of the 64-bit product ``a * m``."""
    mh, ml = m >> 16, m & 0xFFFF
    p = a * mh  # < 2^48
    q = ((p & 0xFFFF) << 16) + a * ml  # < 2^49
    return (p >> 16) + (q >> 32), q & MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int, rounds: int = 10):
    """Philox4x32 of counter words ``c0..c3`` (int64 tensors holding uint32,
    broadcastable) under key ``(k0, k1)``; returns four int64 words."""
    for r in range(rounds):
        if r:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def env_ids(n: int, env_offset: int = 0, device=None) -> torch.Tensor:
    """(n,) int64 global env indices ``env_offset .. env_offset + n - 1``: the
    counter's env word of a launch over ``n`` envs at ``env_offset``."""
    if not (0 <= env_offset and env_offset + n <= 2**32):
        raise ValueError(f"env_offset={env_offset} with {n} envs leaves the 32-bit env word")
    return torch.arange(env_offset, env_offset + n, dtype=torch.int64, device=device)


def uniform_bits(seed: int, env: torch.Tensor, step: int, purpose: int,
                 n: int) -> torch.Tensor:
    """(B, n) int64 uint32 draws for envs ``env`` (B,) at one step."""
    slots = torch.arange(n, dtype=torch.int64, device=env.device)
    e = env.to(torch.int64)[:, None]
    words = philox4x32(
        e, torch.full_like(e, step), torch.full_like(e, purpose), slots[None] >> 2,
        seed & MASK32, (seed >> 32) & MASK32,
    )
    word = (slots & 3)[None].expand(env.shape[0], n)
    return torch.stack(torch.broadcast_tensors(*words), dim=-1).gather(
        2, word[..., None]
    )[..., 0]


def rand_mod(bits: torch.Tensor, m) -> torch.Tensor:
    """Uniform int in [0, m) from uint32 draws: mask to 31 bits, then mod
    (``_rand_mod``, pallas_rollout.py:74-82; bias < 2^-24)."""
    return (bits & 0x7FFFFFFF) % m


def draw_distinct(bits: torch.Tensor, m: int) -> torch.Tensor:
    """n distinct uniform values in [0, m) per row from (B, n) draws.

    Sequential shifted draws (``_draw_distinct``, pallas_rollout.py:85-110):
    draw i is uniform over the m - i values not yet taken; shifting it past
    the already-chosen values in ascending order maps it to its id.  All-zero
    draws give 0, 1, ..., n-1.
    """
    chosen = []
    sorted_cells = []  # ascending per row
    for i in range(bits.shape[1]):
        d = rand_mod(bits[:, i], m - i)
        for c in sorted_cells:
            d = d + (d >= c).to(d.dtype)
        chosen.append(d)
        new_sorted, cur = [], d
        for c in sorted_cells:
            new_sorted.append(torch.minimum(cur, c))
            cur = torch.maximum(cur, c)
        new_sorted.append(cur)
        sorted_cells = new_sorted
    if not chosen:
        return torch.zeros((bits.shape[0], 0), dtype=torch.int64, device=bits.device)
    return torch.stack(chosen, dim=1)


def gumbel_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Float32 uniform in [0, 1) from the low 23 bits
    (``_sample_gumbel``, pallas_rollout.py:1506-1513)."""
    return (bits & 0x7FFFFF).to(torch.float32) * (1.0 / 8388608.0)
