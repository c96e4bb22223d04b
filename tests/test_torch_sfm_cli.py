"""`python -m sift_tpu_torch.cli sfm` on the CPU on the checked-in
real-format fixtures: the TUM-RGBD sequence (10 RGB-D frames at 640x480,
the JAX command's ATE bound of 0.05 m from
`tests/e2e/test_real_format_fixtures.py::test_cli_sfm_tum_fixture`) and
the KITTI sequence run monocular (10 frames at 120x400), and the loop
closure and full-map BA flags on the TUM sequence, whose output lines must
be the JAX command's (but for the timing). The port runs on two CPU
threads, light on a machine that runs other tests beside it."""

import os
import re

import numpy as np
import pytest

from sift_tpu_torch import cli
from tests.torch_dist_world import (  # noqa: F401
    one_torch_thread, torch_threads)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TUM_DIR = os.path.join(FIXDIR, "tum_mini", "rgbd_dataset_freiburg1_mini")
KITTI_ROOT = os.path.join(FIXDIR, "kitti_mini")


@pytest.fixture(autouse=True)
def two_threads():
    with torch_threads(2):
        yield


def _ate(out: str) -> float:
    return float(out.split("ATE RMSE")[1].split(":")[1].split("m")[0])


def test_cli_sfm_tum_fixture(tmp_path, capsys):
    traj = str(tmp_path / "traj.txt")
    tum = str(tmp_path / "traj_tum.txt")
    ply = str(tmp_path / "map.ply")
    metrics = str(tmp_path / "m.jsonl")
    rc = cli.main(["sfm", TUM_DIR, "--format", "tum", "--traj", traj,
                   "--ply", ply, "--metrics", metrics, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "10 frames in" in out, out
    assert "ATE RMSE (se3-aligned)" in out and _ate(out) < 0.05, out
    assert "RPE RMSE (TUM, delta=1)" in out
    assert f"wrote {traj}" in out and f"wrote {ply}" in out
    assert np.loadtxt(traj).shape == (10, 3)
    assert open(metrics).read().count('"event": "frame"') == 10
    # The TUM dialect, per-frame: the same positions with timestamps.
    rc = cli.main(["sfm", TUM_DIR, "--traj", tum, "--traj-format", "tum",
                   "--batch", "1", "--max-frames", "4", "--device", "cpu"])
    rows = np.loadtxt(tum)
    assert rc == 0 and rows.shape == (4, 8)
    np.testing.assert_allclose(rows[:, 1:4], np.loadtxt(traj)[:4], atol=2e-3)
    assert rows[1, 0] - rows[0, 0] == \
        np.float64(1305031100.033333) - np.float64(1305031100.0)


def test_cli_sfm_kitti_monocular(tmp_path, capsys):
    traj = str(tmp_path / "traj.txt")
    rc = cli.main(["sfm", KITTI_ROOT, "--format", "kitti", "--sequence",
                   "05", "--batch", "4", "--traj", traj, "--verbose",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "ATE RMSE (sim3-aligned)" in out and _ate(out) < 0.1, out
    assert out.count("tracked=True") == 10
    assert np.loadtxt(traj).shape == (10, 3)


def test_cli_sfm_loop_flags_print_the_jax_lines(tmp_path, capsys,
                                                monkeypatch):
    """`--loop-closure --global-ba` on the TUM fixture: the port prints the
    JAX command's lines (frame, keyframe and landmark counts, the global
    BA line, ATE and RPE); only the seconds and frames/s differ."""
    from sift_tpu import cli as jax_cli

    # The JAX command keeps its compilation cache under $HOME by default.
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    args = ["sfm", TUM_DIR, "--loop-closure", "--global-ba"]
    assert jax_cli.main(args) == 0
    want = capsys.readouterr().out
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out

    def lines(out):
        return [re.sub(r"in [0-9.]+s \([0-9.]+ fps\)", "in T", line)
                for line in out.splitlines()]

    assert lines(got) == lines(want), (got, want)
    assert any(line.startswith("global BA: ") for line in lines(got))
    assert _ate(got) < 0.05
