"""Shared helpers of the ``test_torch_*`` files: the same inputs, made from a
seed, handed to the JAX package and to its PyTorch port as numpy arrays."""
import jax
import numpy as np
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.parallel import batched_reset as jax_batched_reset
from rware_tpu_torch.convert import state_from_numpy, state_to_numpy

DYNAMICS_FIELDS = (
    "agent_x",
    "agent_y",
    "agent_dir",
    "agent_carrying",
    "agent_has_delivered",
    "shelf_x",
    "shelf_y",
    "cur_steps",
    "cur_inactive_steps",
)
ALL_FIELDS = DYNAMICS_FIELDS + ("request_queue",)


def make_pair(env_id_or_config):
    """(JAX env, port env) of one config; a config object is taken from the
    JAX package and rebuilt field by field for the port."""
    if isinstance(env_id_or_config, str):
        return rware_tpu.make(env_id_or_config), rware_tpu_torch.make(env_id_or_config, device="cpu")
    import dataclasses

    fields = dataclasses.asdict(env_id_or_config)
    return (
        rware_tpu.make(env_id_or_config),
        rware_tpu_torch.make(rware_tpu_torch.WarehouseConfig(**fields), device="cpu"),
    )


def jax_states(jenv, n_envs, seed=0):
    """Batched JAX reset states."""
    states, _ = jax_batched_reset(jenv, jax.random.key(seed), n_envs)
    return states


def to_port(jax_state, batched=True):
    """The port's state of a (batched or single) JAX state."""
    if not batched:
        jax_state = jax.tree.map(lambda x: x[None], jax_state)
    return state_from_numpy(jax_state)


def assert_fields_equal(port_state, jax_state, fields=DYNAMICS_FIELDS, batched=True):
    got = state_to_numpy(port_state)
    for f in fields:
        want = np.asarray(getattr(jax_state, f))
        if not batched:
            want = want[None]
        np.testing.assert_array_equal(got[f], want, err_msg=f)


def check_queue_rule(q_before, q_jax, q_port, n_shelves):
    """Queue resamples drawn from different generators: the same slots are
    replaced, by in-range shelves, and each queue stays distinct (unless
    every shelf is queued)."""
    q_before, q_jax, q_port = (np.asarray(q) for q in (q_before, q_jax, q_port))
    np.testing.assert_array_equal(q_jax != q_before, q_port != q_before)
    assert ((q_port >= 0) & (q_port < n_shelves)).all()
    if q_port.shape[-1] < n_shelves:
        for row in q_port.reshape(-1, q_port.shape[-1]):
            assert len(set(row.tolist())) == row.size, row


def cpu_generator(seed=0):
    return torch.Generator().manual_seed(seed)


def compile_bf16_exact(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` without XLA's excess precision,
    so the JAX side rounds to bf16 wherever its code casts (by default XLA
    on the CPU may keep a bf16 intermediate in float32)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def jit_bf16_exact(fn, *args):
    """``fn(*args)`` through :func:`compile_bf16_exact`."""
    return compile_bf16_exact(fn, *args)(*args)
