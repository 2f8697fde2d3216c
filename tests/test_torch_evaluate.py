"""``evaluate --greedy`` and ``--render-frames`` of the port against the JAX
package's ``evaluate.py``.

The greedy rule (``evaluate.py:142-156``: the argmax move, a message bit
where its logit is > 0) on converted parameters and equal observations gives
JAX's actions for the MLP, the GRU and per-agent nets, with and without
message bits, wherever flax's logits are not within the bf16 bound of the
port's (``tests/test_torch_policy.py``'s ATOL); the entry points play and
write frames on the CPU.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import rware_tpu
from rware_tpu.models import ActorCritic as FlaxActorCritic
from rware_tpu.models import RecurrentActorCritic as FlaxRecurrent
from rware_tpu.rendering import Viewer as JaxViewer
from rware_tpu_torch import convert, evaluate
from rware_tpu_torch.models.networks import init_actor_critic
from tests.torch_ref import jax_states, make_pair

torch.set_num_threads(1)

ATOL = 2e-2  # flax's bf16 roundings against the port's (tests/test_torch_policy.py)
B = 256


def jax_greedy(logits, msg_mode):
    """JAX's rule, as ``evaluate.py:142-156`` writes it."""
    if msg_mode:
        move_logits, msg_logits = logits
        return jnp.concatenate(
            [jnp.argmax(move_logits, -1)[..., None], (msg_logits > 0).astype(jnp.int32)],
            axis=-1).astype(jnp.int32)
    return jnp.argmax(logits, axis=-1).astype(jnp.int32)


def clear_of_ties(logits, msg_mode):
    """Where the port's rounding cannot flip JAX's choice: the top two move
    logits more than ATOL apart, and every message logit past ATOL."""
    move = np.asarray(logits[0] if msg_mode else logits)
    top2 = np.sort(move, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > ATOL
    if msg_mode:
        return np.concatenate([clear[..., None], np.abs(np.asarray(logits[1])) > ATOL], -1)
    return clear


@pytest.mark.parametrize("net,per_agent,msg_bits", [
    ("mlp", False, 0), ("mlp", False, 2), ("gru", False, 0), ("gru", False, 2),
    ("mlp", True, 0), ("mlp", True, 2), ("gru", True, 0)])
def test_greedy_actions_match_jax(net, per_agent, msg_bits):
    jenv, _ = make_pair("rware-tiny-2ag-v2")
    if msg_bits:
        jenv = rware_tpu.make("rware-tiny-2ag-v2", msg_bits=msg_bits)
    n = jenv.n_agents
    obs = np.array(jax.vmap(jenv._obs_fn)(jax_states(jenv, B, seed=4)))
    cls = FlaxRecurrent if net == "gru" else FlaxActorCritic
    model = cls(n_actions=5, msg_bits=msg_bits)
    keys = jax.random.split(jax.random.key(7), n if per_agent else 1)
    args = ((model.initialize_carry((1, n)),) if net == "gru" else ()) + (jnp.asarray(obs[:1]),)
    params = [model.init(k, *args) for k in keys]
    from_flax = convert.recurrent_from_flax if net == "gru" else convert.actor_critic_from_flax
    if per_agent:
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *params)
        policy = nn.ModuleList(from_flax(jax.tree.map(np.asarray, p)) for p in params)
    else:
        policy = from_flax(jax.tree.map(np.asarray, params[0]))
    carry = jnp.zeros((B, n, 128), jnp.bfloat16)
    tcarry = torch.zeros((B, n, 128), dtype=torch.bfloat16)
    for step in range(2):  # the GRU's second step from a nonzero carry
        o = np.roll(obs, step, axis=0)
        if net == "gru" and per_agent:
            carry, (logits, _) = jax.vmap(lambda p, c, x: model.apply(p, c, x),
                                          in_axes=(0, 1, 1), out_axes=1)(stacked, carry, o)
        elif net == "gru":
            carry, (logits, _) = model.apply(params[0], carry, o)
        elif per_agent:
            logits, _ = jax.vmap(lambda p, x: model.apply(p, x), in_axes=(0, 1),
                                 out_axes=1)(stacked, o)
        else:
            logits, _ = model.apply(params[0], o)
        want = np.asarray(jax_greedy(logits, msg_bits > 0))
        with torch.no_grad():
            tlogits, tcarry = evaluate.policy_logits(policy, torch.from_numpy(o), tcarry)
        got = evaluate.greedy_actions(tlogits).numpy()
        assert got.dtype == np.int32 and got.shape == want.shape
        clear = clear_of_ties(logits, msg_bits > 0)
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(got[clear], want[clear])
        if net == "gru":  # carry on JAX's hidden, as the GRU tests do
            tcarry = torch.from_numpy(np.array(carry.astype(jnp.float32))).to(torch.bfloat16)


def _save_mlp(path, msg_bits, seed=0):
    import rware_tpu_torch

    obs_dim = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu",
                                   msg_bits=msg_bits).config.policy_obs_length
    model = init_actor_critic(obs_dim, 5, (16, 16), seed=seed, msg_bits=msg_bits)
    torch.save({"env": "rware-tiny-2ag-v2", "obs_dim": obs_dim, "n_actions": 5,
                "msg_bits": msg_bits, "net": "mlp", "hidden": (16, 16),
                "state_dict": model.state_dict(), "updates": 0}, path)
    return model


@pytest.mark.parametrize("msg_bits", [0, 2])
def test_greedy_entry_point(tmp_path, msg_bits):
    model = _save_mlp(os.path.join(tmp_path, "policy.pt"), msg_bits)
    args = ["--device", "cpu", "--checkpoint-dir", str(tmp_path), "--episodes", "16",
            "--max-steps", "30", "--greedy"]
    stats = evaluate.main(args)
    assert stats == evaluate.main(args)  # the greedy loop is deterministic
    assert stats["episodes"] == 16 and stats["mean_length"] == 30.0
    # per-agent nets that are all the shared net play as the shared net
    import rware_tpu_torch

    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu", msg_bits=msg_bits)
    shared = evaluate.greedy_return(env, model, 16, 30)
    stack = evaluate.greedy_return(env, nn.ModuleList([model, model]), 16, 30)
    assert shared == stack == stats


def test_render_frames(tmp_path):
    _save_mlp(os.path.join(tmp_path, "policy.pt"), 0)
    out = os.path.join(tmp_path, "frames")
    evaluate.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path), "--episodes", "4",
                   "--max-steps", "5", "--render-frames", out])
    names = sorted(os.listdir(out))
    assert len(names) == 60 and names[0].startswith("frame_000.")
    from PIL import Image

    first = np.asarray(Image.open(os.path.join(out, names[0])))
    # frame 0 is env 0 of the evaluation's reset, drawn as JAX draws it
    import rware_tpu_torch
    from rware_tpu_torch.parallel import batched_reset

    state, _ = batched_reset(rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu"), 0, 4)
    jstate = jax.tree.map(jnp.asarray, {k: v[0].numpy() for k, v in state.__dict__.items()})
    want = JaxViewer(rware_tpu.parse_env_id("rware-tiny-2ag-v2")).frame(
        type("S", (), jstate)())
    assert first.tobytes() == want.tobytes()
    frames = [np.asarray(Image.open(os.path.join(out, f))) for f in names]
    assert any(not np.array_equal(frames[0], f) for f in frames[1:])  # the agents move
    greedy = os.path.join(tmp_path, "greedy")
    assert len(evaluate.render_frames(
        rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu"), None, greedy, n_frames=3)) == 3
