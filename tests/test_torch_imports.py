"""Import hygiene of the port and its import-time Gymnasium registration.

The port imports torch and never jax: a fresh interpreter that imports every
module of ``rware_tpu_torch`` holds no ``jax`` and no ``rware_tpu`` module,
and every id it registered names the port's entry points.  Where both
packages are imported, the first keeps the ids.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_python(script: str) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("RWARE_TPU_NO_REGISTER", None)
    env.pop("RWARE_TPU_AUTO_REGISTER", None)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


_WALK_SCRIPT = """
import importlib, pkgutil, sys
import rware_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rware_tpu_torch.__path__, "rware_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for must in ("gym_adapter", "vector", "utils", "utils.spaces", "utils.wrappers", "rendering",
             "debug", "human_play", "core.host", "profiling", "distributed",
             "parallel.sharding"):
    assert "rware_tpu_torch." + must in names, must
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "rware_tpu" or m.startswith("rware_tpu."))
assert not bad, bad
import gymnasium as gym
ids = [k for k in gym.registry if k.startswith("rware")]
assert len(ids) == 4 * 19 * 3, len(ids)
for k in ids:
    spec = gym.registry[k]
    assert spec.entry_point == "rware_tpu_torch.gym_adapter:GymWarehouse", (k, spec.entry_point)
    assert spec.vector_entry_point == "rware_tpu_torch.vector:vector_entry_point", k
for name in ("make_gym", "make_vec", "register_all"):
    assert callable(getattr(rware_tpu_torch, name)), name
print(len(names), "modules")
"""


def test_the_port_imports_no_jax_and_registers_its_own_entry_points():
    assert run_python(_WALK_SCRIPT).endswith("modules")


_ORDER_SCRIPT = """
import {first}, {second}
import gymnasium as gym
spec = gym.spec("rware-tiny-2ag-v2")
print(spec.entry_point, spec.vector_entry_point)
"""


@pytest.mark.parametrize("first,second,want", [
    ("rware_tpu", "rware_tpu_torch",
     "rware_tpu.gym_adapter:GymWarehouse rware_tpu.vector:vector_entry_point"),
    ("rware_tpu_torch", "rware_tpu",
     "rware_tpu_torch.gym_adapter:GymWarehouse rware_tpu_torch.vector:vector_entry_point"),
])
def test_import_time_registration_keeps_the_first_package(first, second, want):
    assert run_python(_ORDER_SCRIPT.format(first=first, second=second)) == want


def test_registration_opt_outs():
    script = """
import os
os.environ["RWARE_TPU_NO_REGISTER"] = "1"
import rware_tpu_torch, gymnasium as gym
n0 = sum(k.startswith("rware") for k in gym.registry)
print(n0, rware_tpu_torch.register_all(image=True))
"""
    assert run_python(script) == f"0 {5 * 4 * 19 * 3}"
