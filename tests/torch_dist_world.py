"""Gloo worlds of port processes for the distributed tests
(`tests/test_torch_dist_*.py`).

`World(tmp_path, body, size)` writes a worker script (a common preamble,
then `body`) and starts `size` processes of it, each a rank of a gloo
world joined through a file store in `tmp_path` (no ports, so xdist
workers cannot clash). The processes import the port and never JAX: the
epilogue fails the rank if any JAX or `sift_tpu` module got imported. A
body reads the inputs the test wrote with `np.savez(tmp_path / "in.npz")`
as `IN` and writes its outputs with `save(name, **arrays)`; the test reads
them with `World.load(name, rank)`. `World.wait` bounds the whole world by
a timeout and kills every rank on expiry.

Also the thread settings of every port test module: `torch_threads(n)`
runs a block on n PyTorch threads, `one_torch_thread` (imported into a
module, an autouse fixture) runs its tests on one, and `ONE_THREAD_ENV`
is the environment for the processes they start. The test runner's
workers share the cores; PyTorch's default of a thread a core in each of
them oversubscribes the machine (6 workers at 8 threads each on 8 cores),
and the port's tests then take a third longer in all. The gloo ranks run
at one thread too.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@contextlib.contextmanager
def torch_threads(n: int = 1):
    """Run the block on `n` CPU threads of PyTorch."""
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's tests on one PyTorch thread; the count is restored."""
    with torch_threads(1):
        yield

_PREAMBLE = '''
import os, sys, warnings
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
warnings.simplefilter("ignore", FutureWarning)
RANK, WORLD, DIR = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from sift_tpu_torch.dist.mesh import init_distributed
init_distributed("cpu", "file://" + os.path.join(DIR, f"store_w{{WORLD}}"),
                 RANK, WORLD)
_in = os.path.join(DIR, "in.npz")
IN = dict(np.load(_in)) if os.path.exists(_in) else {{}}


def save(name, **arrays):
    np.savez(os.path.join(DIR, f"{{name}}_w{{WORLD}}_r{{RANK}}.npz"), **arrays)

'''

_EPILOGUE = '''
bad = [m for m in sys.modules if m in ("jax", "flax", "sift_tpu")
       or m.startswith(("jax.", "jaxlib", "flax.", "sift_tpu."))]
assert not bad, bad
from sift_tpu_torch.dist.mesh import shutdown_distributed
shutdown_distributed()
'''


class World:
    """`size` ranks of `body`, started at construction."""

    def __init__(self, tmp_path, body: str, size: int, args=()):
        self.dir = str(tmp_path)
        self.size = size
        script = os.path.join(self.dir, f"worker_w{size}.py")
        with open(script, "w") as f:
            f.write(_PREAMBLE.format(repo=REPO) + body + _EPILOGUE)
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env.update(ONE_THREAD_ENV, PYTHONPATH="")
        self.procs = [subprocess.Popen(
            [sys.executable, script, str(rank), str(size), self.dir,
             *map(str, args)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for rank in range(size)]
        self.returncodes = None
        self.stderr = None

    def wait(self, timeout: float, check: bool = True) -> "World":
        """Wait for every rank, at most `timeout` seconds in all; kill
        every rank on expiry. With `check`, every rank must exit 0."""
        deadline = time.monotonic() + timeout
        errs = []
        try:
            for p in self.procs:
                _, err = p.communicate(
                    timeout=max(deadline - time.monotonic(), 0.1))
                errs.append(err)
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            for p in self.procs:
                p.communicate()
            raise AssertionError(f"a world of {self.size} ranks ran past "
                                 f"{timeout} s")
        self.returncodes = [p.returncode for p in self.procs]
        self.stderr = errs
        if check:
            for rank, (rc, err) in enumerate(zip(self.returncodes, errs)):
                assert rc == 0, f"rank {rank} of {self.size}: rc {rc}\n" \
                    + err[-4000:]
        return self

    def load(self, name: str, rank: int = 0) -> dict:
        path = os.path.join(self.dir, f"{name}_w{self.size}_r{rank}.npz")
        with np.load(path) as z:
            return dict(z)

    def assert_replicated(self, name: str) -> dict:
        """Every rank's arrays of `name` bit-identical to rank 0's; returns
        rank 0's."""
        ref = self.load(name, 0)
        for rank in range(1, self.size):
            got = self.load(name, rank)
            assert sorted(got) == sorted(ref)
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k],
                                              err_msg=f"{name}.{k} rank "
                                              f"{rank}")
        return ref
