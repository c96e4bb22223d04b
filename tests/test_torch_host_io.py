"""The port's host modules on the CPU: checkpoints (`io/checkpoint.py`),
the native decoder binding (`io/native.py`) against the JAX package's,
the trajectory plot (`io/viz.py::plot_trajectory`, `cli sfm --plot`) and
the debug utilities (`utils/debug.py`). PyTorch runs on two threads,
light on a machine that runs other tests beside it."""

import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
from PIL import Image

from sift_tpu.io import native as jax_native

from sift_tpu_torch import cli
from sift_tpu_torch.ba.solver import BAState
from sift_tpu_torch.io import checkpoint, native
from sift_tpu_torch.io.image import save_image_gray
from sift_tpu_torch.io.viz import plot_trajectory
from sift_tpu_torch.utils.debug import (assert_trees_equal, check_finite,
                                        debug_nans)
from tests.torch_dist_world import (  # noqa: F401
    one_torch_thread, torch_threads)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUM_DIR = os.path.join(_REPO, "tests", "fixtures", "tum_mini",
                       "rgbd_dataset_freiburg1_mini")


@pytest.fixture(autouse=True)
def two_threads():
    with torch_threads(2):
        yield


def _ba_state(seed: int = 0) -> BAState:
    g = torch.Generator().manual_seed(seed)
    return BAState(poses=torch.randn(8, 6, generator=g),
                   landmarks=torch.randn(64, 3, generator=g),
                   cost=torch.tensor(1.5), rmse=torch.tensor(0.25),
                   damping=torch.tensor(1e-3),
                   iterations=torch.tensor(7, dtype=torch.int32),
                   cg_iters=torch.tensor(31, dtype=torch.int32))


def _state():
    return {"ba": _ba_state(), "frame": 17, "name": "seq", "none": None,
            "keyframes": [3, 9, 12], "ids": np.arange(5, dtype=np.int64),
            "mask": np.array([True, False, True]),
            "pair": (torch.ones(2, 2, dtype=torch.bfloat16), 2.5),
            "view": torch.arange(100.0).reshape(10, 10)[:, 3]}


# --- checkpoints -------------------------------------------------------------

def test_checkpoint_round_trip_without_target(tmp_path):
    path = str(tmp_path / "ckpt.pt")
    state = _state()
    checkpoint.save_checkpoint(path, state)
    back = checkpoint.restore_checkpoint(path)
    assert isinstance(back["ba"], dict)              # no target: fields
    assert torch.equal(back["ba"]["landmarks"], state["ba"].landmarks)
    assert back["ba"]["iterations"].dtype == torch.int32
    assert back["frame"] == 17 and back["name"] == "seq"
    assert back["none"] is None and back["keyframes"] == [3, 9, 12]
    np.testing.assert_array_equal(back["ids"], state["ids"])
    assert back["ids"].dtype == np.int64 and back["mask"].dtype == bool
    assert isinstance(back["pair"], tuple) and back["pair"][1] == 2.5
    assert back["pair"][0].dtype == torch.bfloat16
    assert torch.equal(back["view"], state["view"])
    # A compact copy of the view, not its 100-element storage.
    assert back["view"].untyped_storage().nbytes() == 10 * 4
    # torch.load's default (weights_only) reads the file: no pickled class.
    payload = torch.load(path)
    assert payload["format"] == "sift_tpu_torch.checkpoint/1"


def test_checkpoint_restores_into_target(tmp_path):
    path = str(tmp_path / "ckpt.pt")
    state = _state()
    checkpoint.save_checkpoint(path, state)
    target = _state()
    target["ba"] = _ba_state(1).replace(poses=torch.zeros(8, 6,
                                                          dtype=torch.float64))
    back = checkpoint.restore_checkpoint(path, target=target)
    assert isinstance(back["ba"], BAState)
    assert back["ba"].poses.dtype == torch.float64     # the target's dtype
    assert torch.equal(back["ba"].poses, state["ba"].poses.double())
    assert_trees_equal(back["ba"].replace(poses=back["ba"].poses.float()),
                       state["ba"])
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore_checkpoint(
            path, target=dict(target, view=torch.zeros(3)))
    with pytest.raises(ValueError, match="keys"):
        checkpoint.restore_checkpoint(path, target={"ba": target["ba"]})
    with pytest.raises(FileExistsError):
        checkpoint.save_checkpoint(path, state, force=False)
    with pytest.raises(TypeError):
        checkpoint.save_checkpoint(str(tmp_path / "x.pt"), {"f": object()})


def test_checkpoint_manager_rotation(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in (1, 5, 10, 12):
        mgr.save(step, {"step": torch.tensor(step), "ba": _ba_state(step)})
    mgr.wait()
    assert mgr.all_steps() == [10, 12] and mgr.latest_step() == 12
    assert int(mgr.restore()["step"]) == 12
    back = mgr.restore(10, target={"step": torch.tensor(0),
                                   "ba": _ba_state(0)})
    assert_trees_equal(back["ba"], _ba_state(10))
    mgr.close()


def test_interrupted_save_keeps_the_last_good_file(tmp_path, monkeypatch):
    path = str(tmp_path / "ckpt.pt")
    checkpoint.save_checkpoint(path, {"x": torch.ones(3)})
    real = torch.save

    def dies_midway(obj, fh):
        fh.write(b"partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", dies_midway)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save_checkpoint(path, {"x": torch.zeros(3)})
    monkeypatch.setattr(torch, "save", real)
    assert torch.equal(checkpoint.restore_checkpoint(path)["x"], torch.ones(3))
    assert os.listdir(tmp_path) == ["ckpt.pt"]


_RUNNER = textwrap.dedent("""
    import sys, time, torch
    from sift_tpu_torch.io.checkpoint import CheckpointManager

    def step_fn(x, k):               # exact: integer arithmetic
        return (x * 1103515245 + 12345 + k) & 0x7FFFFFFF

    mgr = CheckpointManager(sys.argv[1], max_to_keep=2)
    steps = int(sys.argv[2])
    start = mgr.latest_step()
    if start is None:
        x, k0 = torch.arange(1 << 16), 0
    else:
        x, k0 = mgr.restore(start)["x"], start + 1
    for k in range(k0, steps):
        x = step_fn(x, k)
        mgr.save(k, {"x": x, "step": k})
        print(k, flush=True)
        time.sleep(0.01)           # so that the kill lands mid-run
""")


def _expected(steps: int) -> torch.Tensor:
    x = torch.arange(1 << 16)
    for k in range(steps):
        x = (x * 1103515245 + 12345 + k) & 0x7FFFFFFF
    return x


def test_kill_and_resume(tmp_path):
    """A run killed (SIGKILL) mid-way resumes from its last good step and
    ends where an uninterrupted run ends."""
    script = tmp_path / "runner.py"
    script.write_text(_RUNNER)
    ckpts = str(tmp_path / "ckpts")
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="2")
    steps = 100
    proc = subprocess.Popen([sys.executable, str(script), ckpts, str(steps)],
                            env=env, stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(5):                 # let it save a few steps
            assert proc.stdout.readline().strip(), "runner ended early"
        time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
    mgr = checkpoint.CheckpointManager(ckpts, max_to_keep=2)
    last = mgr.latest_step()
    assert last is not None and 4 <= last < steps - 1
    assert torch.equal(mgr.restore()["x"], _expected(last + 1))
    out = subprocess.run([sys.executable, str(script), ckpts, str(steps)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) == last + 1
    assert mgr.latest_step() == steps - 1
    assert torch.equal(mgr.restore()["x"], _expected(steps))


# --- native decode -------------------------------------------------------------

def _images(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        p = str(tmp_path / f"f{i}.png")
        save_image_gray(p, rng.uniform(0, 255, (16 + i, 21)))
        paths.append(p)
    rgb = str(tmp_path / "rgb.png")
    Image.fromarray(rng.integers(0, 256, (25, 31, 3), dtype=np.uint8),
                    "RGB").save(rgb)
    depth = str(tmp_path / "depth.png")
    Image.fromarray(np.arange(12, dtype=np.uint16).reshape(3, 4) * 1000).save(
        depth)
    return paths + [rgb, depth]


def test_native_decode_equals_the_jax_binding(tmp_path):
    assert native.native_available() == jax_native.native_available()
    paths = _images(tmp_path) + [os.path.join(
        TUM_DIR, "rgb", "1305031100.000000.png")]
    for p in paths:
        a, b = native.load_image_gray_native(p), \
            jax_native.load_image_gray_native(p)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    if native.native_available():
        assert native.load_image_gray_native(str(tmp_path / "none.png")) \
            is None
        got = list(native.NativeLoader(paths, threads=3, queue_cap=2))
        want = list(jax_native.NativeLoader(paths, threads=3, queue_cap=2))
        assert len(got) == len(want) == len(paths)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(IOError):
            list(native.NativeLoader([paths[0], str(tmp_path / "none.png")]))


# --- trajectory plot -------------------------------------------------------

def test_plot_trajectory_writes_a_png(tmp_path):
    t = np.linspace(0, 1, 20)
    est = np.stack([t, 0 * t, t ** 2], -1)
    path = str(tmp_path / "traj.png")
    assert plot_trajectory(est, est + 0.01, path=path, title="t") is None
    with Image.open(path) as im:
        assert im.format == "PNG" and im.size[0] > 100
    fig = plot_trajectory(est)
    assert fig is not None and len(fig.axes) == 1


def test_cli_sfm_plot(tmp_path, capsys):
    path = str(tmp_path / "traj.png")
    assert cli.main(["sfm", TUM_DIR, "--device", "cpu", "--max-frames", "4",
                     "--plot", path]) == 0
    assert f"wrote {path}" in capsys.readouterr().out
    with Image.open(path) as im:
        assert im.format == "PNG"


# --- debug utilities ---------------------------------------------------------

def test_check_finite_and_assert_trees_equal():
    state = {"ba": _ba_state(), "xs": [np.ones(3), torch.zeros(2)]}
    check_finite(state)
    bad = {"ba": _ba_state().replace(landmarks=torch.full((4, 3), np.nan)),
           "xs": []}
    with pytest.raises(FloatingPointError, match="12 non-finite"):
        check_finite(bad, name="map")
    check_finite({"ids": np.array([1, 2])})            # integers pass
    assert_trees_equal(state, {"ba": _ba_state(), "xs": [np.ones(3),
                                                         torch.zeros(2)]})
    near = {"ba": _ba_state().replace(cost=torch.tensor(1.5 + 1e-6)),
            "xs": [np.ones(3), torch.zeros(2)]}
    with pytest.raises(AssertionError):
        assert_trees_equal(state, near)
    assert_trees_equal(state, near, atol=1e-5)
    with pytest.raises(AssertionError, match="structure"):
        assert_trees_equal(state, {"ba": _ba_state(), "xs": [np.ones(3)]})


def test_debug_nans_names_the_operator():
    x = torch.tensor([0.0, 1.0])
    with pytest.raises(FloatingPointError, match=r"aten\.div"):
        with debug_nans():
            y = x * 2.0
            y / x[0]
    with debug_nans():                       # infinities pass, as in JAX
        torch.tensor([1.0]) / 0.0
        torch.nn.functional.pad(x, (1, 1), value=float("-inf"))
    with debug_nans(False):
        assert torch.isnan(x / x[0]).any()
    # The previous mode stack is back after the block.
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    assert _get_current_dispatch_mode() is None
