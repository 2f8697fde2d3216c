"""Rank processes of the port's data-parallel tests on the CPU: ``python -m
tests.torch_dp_worker SPEC RANK`` is one rank of
:func:`rware_tpu_torch.testing.dp_spawn`'s gloo process group; it runs the
spec's tasks (:func:`rware_tpu_torch.testing.dp_task`) and writes their
results for :func:`rware_tpu_torch.testing.dp_results`.

It imports torch and the port, never jax.  :func:`spawn` starts the ranks
with one thread each, as the tests run theirs.
"""
import sys

from rware_tpu_torch.testing import dp_rank_main, dp_results, dp_spawn

ENTRY = (sys.executable, "-m", "tests.torch_dp_worker")


def spawn(tasks: list, world: int, tmp_dir: str) -> list:
    """Start ``world`` rank processes on ``tasks`` (gloo, the CPU, one
    thread); returns their ``Popen``."""
    return dp_spawn(ENTRY, tasks, world, tmp_dir, threads=1)


def results(procs: list, tasks: list, tmp_dir: str) -> dict:
    """{task name: [rank 0's result, ...]} once every rank exits."""
    return dp_results(procs, tasks, tmp_dir, timeout=240)


if __name__ == "__main__":
    dp_rank_main(sys.argv[1], int(sys.argv[2]))
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
