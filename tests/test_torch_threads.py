"""The port's CPU tests run torch on one intra-op thread per process.

The suite runs in several worker processes at once (pytest-xdist), each
of which collects every test module, so importing this module sets the
thread count of every worker before any test runs.  Torch's default, one
thread per core in every worker, oversubscribes the cores: on an 8-core
host with 6 workers the port's test files took 782 s of wall time and 80
CPU-minutes with the default and 506 s and 37 CPU-minutes with one
thread, and the JAX package's tests in the same run compete for those
cores.  The tests' arrays are at most 256^2, too small for intra-op
threads to pay.  Results change only in the rounding of a few parallel
reductions, far below every tolerance of the port's tests, and the
tests that compare two torch results bit for bit compare them within
one process.
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)


def test_torch_runs_one_thread_per_process():
    assert torch.get_num_threads() == 1
