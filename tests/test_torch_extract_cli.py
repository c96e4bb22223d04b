"""`cli extract` of the PyTorch port (plain path on the CPU) against the JAX
package's command on a TUM fixture frame, in both modes: the printed
keypoint count, `interstpoints.txt` parsed row by row, the overlay, and
the drawing helpers. Each command runs in its own directory under
tmp_path, which holds a copy of the frame (the overlay lands beside the
image, the table in the working directory)."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

from sift_tpu import cli as jax_cli

from sift_tpu_torch import cli
from tests.torch_dist_world import one_torch_thread  # noqa: F401

_FRAME = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "tum_mini", "rgbd_dataset_freiburg1_mini", "rgb",
                      "1305031100.000000.png")


def _run(main, argv, workdir):
    """Run a CLI `main` in `workdir` on a copy of the frame; returns
    (rc, stdout, table rows or None, overlay or None)."""
    os.makedirs(workdir)
    shutil.copy(_FRAME, os.path.join(workdir, "f.png"))
    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = main([a if a != "IMG" else "f.png" for a in argv])
    finally:
        os.chdir(cwd)
    table = os.path.join(workdir, "interstpoints.txt")
    overlay = os.path.join(workdir, "f.png_orientation.png")
    from PIL import Image
    rows = _parse(table) if os.path.exists(table) else None
    img = np.asarray(Image.open(overlay)) if os.path.exists(overlay) else None
    return rc, out.getvalue(), rows, img


def _parse(path):
    """interstpoints.txt -> (N, 4) [x, y, scale, orientation] and (N, 128)
    descriptors."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    assert lines[0] == "Location\tscale\torientation\tdescriptors"
    head, desc = [], []
    for line in lines[1:]:
        loc, scale, ori, d = line.split("\t")
        x, y = (float(v) for v in loc.strip("[]").split(","))
        head.append([x, y, float(scale), float(ori)])
        desc.append([float(v) for v in d.strip("[]").split(",")[:-1]])
    return np.array(head), np.array(desc)


@pytest.fixture(scope="module", params=["parity", "lowe"])
def both(request, tmp_path_factory):
    base = tmp_path_factory.mktemp(f"cli_{request.param}")
    argv = ["extract", "IMG", "-r", "1", "--mode", request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(base / "xla_cache"))
        want = _run(jax_cli.main, argv, str(base / "jax"))
    got = _run(cli.main, argv + ["--device", "cpu"], str(base / "port"))
    return request.param, got, want


def _sorted_rows(rows):
    head, desc = rows
    order = np.lexsort((head[:, 2], head[:, 1], head[:, 0]))
    return head[order], desc[order]


def test_table_and_count_match_jax(both):
    mode, (rc, out, rows, _), (jrc, jout, jrows, _) = both
    assert rc == 0 and jrc == 0
    assert out.splitlines()[0] == jout.splitlines()[0]
    n = int(out.split()[0])
    assert n > 100 and rows[0].shape == (n, 4) and rows[1].shape == (n, 128)
    if mode == "parity":
        # never moved, canonical order: the rows agree one for one
        (head, desc), (jhead, jdesc) = rows, jrows
        np.testing.assert_array_equal(head[:, :3], jhead[:, :3])
    else:
        # slot order follows the score, which may tie
        (head, desc), (jhead, jdesc) = _sorted_rows(rows), _sorted_rows(jrows)
        np.testing.assert_allclose(head[:, :3], jhead[:, :3], rtol=1e-5,
                                   atol=1e-4)
    np.testing.assert_array_equal(np.isnan(head[:, 3]), np.isnan(jhead[:, 3]))
    assert np.isnan(jhead[:, 3]).all() == (mode == "parity")
    fin = ~np.isnan(jhead[:, 3])
    dori = np.abs((head[fin, 3] - jhead[fin, 3] + 180.0) % 360.0 - 180.0)
    assert fin.sum() == 0 or dori.max() < 1e-2
    np.testing.assert_allclose(desc, jdesc, rtol=0, atol=2e-3)


def test_overlay_matches_jax(both):
    mode, (_, _, _, img), (_, _, _, jimg) = both
    assert img.shape == jimg.shape == (480, 640, 3)
    if mode == "parity":
        np.testing.assert_array_equal(img, jimg)
    else:
        # sub-pixel centres may round to other pixels
        assert (img != jimg).any(axis=-1).mean() < 1e-3


def test_bare_image_path_means_extract(tmp_path):
    ref = _run(cli.main, ["extract", "IMG", "-r", "1", "--device", "cpu"],
               str(tmp_path / "sub"))
    bare = _run(cli.main, ["IMG", "-r", "1", "--device", "cpu"],
                str(tmp_path / "bare"))
    assert bare[0] == 0 and "mode=parity" in bare[1]
    assert bare[1].splitlines()[0] == ref[1].splitlines()[0]
    for a, b in zip(bare[2], ref[2]):
        np.testing.assert_array_equal(a, b)


def test_no_image_is_an_error(tmp_path):
    assert _run(cli.main, ["extract", "--device", "cpu"],
                str(tmp_path / "none"))[0] == 2


def test_viz_helpers_match_jax():
    rng = np.random.default_rng(0)
    n = 40
    x, y = rng.uniform(0, 300, n), rng.uniform(0, 200, n)
    octave = rng.integers(0, 4, n)
    scale = rng.uniform(0.5, 6.0, n)
    ori = rng.uniform(0, 360, n)
    ori[:5] = np.nan
    for sub in (False, True):
        got = cli.viz_geometry(x, y, octave, scale, ori, sub)
        want = jax_cli.viz_geometry(x, y, octave, scale, ori, sub)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for i in range(n):
        np.testing.assert_array_equal(
            cli.square_corners(x[i], y[i], scale[i] * 10, ori[i]),
            jax_cli.square_corners(x[i], y[i], scale[i] * 10, ori[i]))
    rgb = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    cx, cy, side, ang = cli.viz_geometry(x / 3, y / 3, octave, scale, ori,
                                         False)
    drawn = cli.draw_keypoints(rgb, cx, cy, side, ang)
    np.testing.assert_array_equal(
        drawn, jax_cli.draw_keypoints(rgb, cx, cy, side, ang))
    assert (drawn != rgb).any()


def test_matching_commands_default_to_lowe():
    p = cli.build_parser()
    assert p.parse_args(["extract", "a.png"]).mode == "parity"
    assert p.parse_args(["match", "a.png", "b.png"]).mode == "lowe"
    assert p.parse_args(["twoview", "a.png", "b.png"]).mode == "lowe"
    assert p.parse_args(["match", "a.png", "b.png", "--mode",
                         "parity"]).mode == "parity"
