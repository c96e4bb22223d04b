"""The port's feature service (`sift_tpu_torch.serve`) against the JAX
package's (`sift_tpu.serve`) on the CPU, at the JAX serve tests' size
(180x240, 3 octaves, 256 keypoints), on crops of the TUM fixture frames.

- Extraction: keypoints compared as sets (same octave, position within
  1e-3 px, orientation within 0.1 deg) with at least 99% of each side's
  matched, scale and score within 1e-3, q8 descriptors within one step
  (1/255) plus the f32 extraction's 6e-3.
- Matching: the matched coordinate pairs as sets, within 1e-3 px, and
  distances within 1e-3.
- Two-view: JAX's Gumbel draws (`PRNGKey(0)`, as `two_view` makes them)
  are handed to the port with their columns moved to follow the port's
  match order (the two packages order near-equal distances differently).
  R within 0.05 deg and t within 0.2 deg of JAX's (the twoview slice's
  tolerances), inliers within one; both within 0.1 / 2 deg of the
  ground truth.
- The host helpers: `_fit` bit-equal on letterboxed shapes, strict-shape
  refusal, q8 rounding half to even.
- The HTTP front on an ephemeral port (a 400 on a bad payload, `/stats`
  keys equal to JAX's).

Co-batching, load and `python -m sift_tpu_torch.serve` are in
`test_torch_serve_batching.py`. PyTorch runs on two threads here, light
on a machine that runs other tests beside it.
"""

import base64
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.optimize import linear_sum_assignment

import jax

from sift_tpu.config import MatchConfig as JaxMatchConfig
from sift_tpu.config import SiftConfig as JaxSiftConfig
from sift_tpu.serve import FeatureService as JaxFeatureService
from sift_tpu.serve import make_handler as jax_make_handler

from sift_tpu_torch.config import MatchConfig, SiftConfig
from sift_tpu_torch.io.image import load_image_gray
from sift_tpu_torch.serve import FeatureService, make_handler
from tests.torch_dist_world import (  # noqa: F401
    one_torch_thread, torch_threads)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RGB = os.path.join(_REPO, "tests", "fixtures", "tum_mini",
                    "rgbd_dataset_freiburg1_mini", "rgb")
FRAMES = [os.path.join(_RGB, f) for f in ("1305031100.000000.png",
                                          "1305031100.300000.png")]
TUM_FR1 = (517.3, 516.5, 318.6, 255.3)
H, W = 180, 240
# The extraction crop (the frame's most textured 180x240 window: 68
# keypoints) and the two-view crop (34 matches, a well-conditioned pose).
CROP = (60, 0)
POSE_CROP = (180, 360)
Q8 = 1.0 / 255.0


@pytest.fixture(autouse=True)
def two_threads():
    with torch_threads(2):
        yield


def _sift(cls):
    return cls(mode="lowe", octaves=3, max_keypoints=256,
               max_keypoints_per_octave=256)


def _crop(img, at):
    return img[at[0]:at[0] + H, at[1]:at[1] + W]


@pytest.fixture(scope="module")
def frames():
    return [load_image_gray(f) for f in FRAMES]


@pytest.fixture(scope="module")
def img(frames):
    return _crop(frames[0], CROP)


@pytest.fixture(scope="module")
def services():
    jax_svc = JaxFeatureService(H, W, sift=_sift(JaxSiftConfig),
                                match=JaxMatchConfig(max_matches=256))
    # One image a dispatch, as the JAX service's `_extract1`.
    svc = FeatureService(H, W, sift=_sift(SiftConfig),
                         match=MatchConfig(max_matches=256), device="cpu",
                         max_batch=1)
    svc.warmup()
    return jax_svc, svc


def _set_share(a, b, tol=1e-3):
    """Share of `a`'s valid keypoints with a counterpart in `b`, and the
    largest scale, score and descriptor differences over the pairs."""
    vb = np.flatnonzero(b["valid"])
    n, worst = 0, [0.0, 0.0, 0.0]
    va = np.flatnonzero(a["valid"])
    for s in va:
        cand = vb[(b["octave"][vb] == a["octave"][s])
                  & (np.abs(b["x"][vb] - a["x"][s]) < tol)
                  & (np.abs(b["y"][vb] - a["y"][s]) < tol)]
        dori = np.abs((b["orientation"][cand] - a["orientation"][s]
                       + 180.0) % 360.0 - 180.0)
        cand = cand[dori < 0.1]
        if cand.size:
            n += 1
            c = cand[np.argmin(np.abs(b["desc"][cand] - a["desc"][s])
                               .max(axis=1))]
            worst = [max(worst[0], abs(float(b["scale"][c] - a["scale"][s]))),
                     max(worst[1], abs(float(b["score"][c] - a["score"][s]))),
                     max(worst[2], float(np.abs(b["desc"][c]
                                                - a["desc"][s]).max()))]
    return n / max(va.size, 1), worst


def test_extraction_matches_jax(services, img):
    jax_svc, svc = services
    want, got = jax_svc.extract(img), svc.extract(img)
    assert want["desc"].dtype == got["desc"].dtype == np.float32
    assert got["x"].shape == want["x"].shape == (256,)
    assert int(want["valid"].sum()) > 40
    for a, b in ((got, want), (want, got)):
        share, (d_scale, d_score, d_desc) = _set_share(a, b)
        assert share >= 0.99
        assert d_scale < 1e-3 and d_score < 1e-3
        assert d_desc <= Q8 + 6e-3


def _pair_matches(mj, mp):
    """Pair JAX's match slots with the port's: valid slots by coordinates
    and distance (two keypoints can share a position, with two
    orientations), invalid slots with each other. Returns (JAX slots,
    port slots, the largest coordinate gap, the largest distance gap) of
    the valid pairs."""
    def rows(mm):
        return np.stack([mm["xa"], mm["ya"], mm["xb"], mm["yb"],
                         mm["distance"] * 100.0], -1)
    vj, vp = mj["valid"], mp["valid"]
    cost = np.abs(rows(mj)[:, None, :] - rows(mp)[None, :, :]).max(-1)
    cost = np.where(vj[:, None] & vp[None, :], cost,
                    np.where(~vj[:, None] & ~vp[None, :], 0.0, 1e9))
    rj, cp = linear_sum_assignment(cost)
    ok = vj[rj]
    gap = np.abs(rows(mj)[rj[ok]] - rows(mp)[cp[ok]])
    return rj, cp, float(gap[:, :4].max()), float(gap[:, 4].max()) / 100.0


def test_match_images_matches_jax(services, img, frames):
    jax_svc, svc = services
    b = _crop(frames[1], CROP)
    mj, mp = (s.match_images(img, b) for s in services)
    assert int(mj["valid"].sum()) >= 20
    assert int(mp["valid"].sum()) == int(mj["valid"].sum())
    _, _, d_xy, d_dist = _pair_matches(mj, mp)
    assert d_xy < 1e-3 and d_dist < 1e-3

    shifted = np.roll(img, 5, axis=1)
    mm = svc.match_images(img, shifted)
    v = mm["valid"]
    assert v.sum() > 15
    assert abs(np.median(mm["xb"][v] - mm["xa"][v]) - 5.0) < 1.0


def _rot_deg(R) -> float:
    R = np.asarray(R, np.float64)
    s = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(s, (np.trace(R) - 1.0) / 2.0)))


def _dir_deg(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    c = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _noise_in_port_order(mj, mp, g):
    """JAX's Gumbel columns moved to the port's match slots."""
    rj, cp, d_xy, _ = _pair_matches(mj, mp)
    assert d_xy < 1e-3
    perm = np.empty(len(cp), int)
    perm[cp] = rj
    return g[:, perm]


def test_two_view_fed_jax_noise(services, frames):
    jax_svc, svc = services
    a, b = (_crop(f, POSE_CROP) for f in frames)
    intr = (TUM_FR1[0], TUM_FR1[1], TUM_FR1[2] - POSE_CROP[1],
            TUM_FR1[3] - POSE_CROP[0])
    want = jax_svc.two_view(a, b, intr)
    g = np.array(jax.random.gumbel(jax.random.PRNGKey(0), (512, 256)))
    noise = _noise_in_port_order(jax_svc.match_images(a, b),
                                 svc.match_images(a, b), g)
    got = svc.two_view(a, b, intr, noise=torch.from_numpy(noise))
    assert got["success"] and want["success"]
    assert got["n_matches"] == want["n_matches"] >= 30
    assert abs(got["num_inliers"] - want["num_inliers"]) <= 1
    assert _rot_deg(got["R"] @ want["R"].T) < 0.05
    assert _dir_deg(got["t"], want["t"]) < 0.2
    assert _rot_deg(got["R"]) < 0.1 and _dir_deg(got["t"], [-1, 0, 0]) < 2.0
    # The default draws: a generator seeded with 0 at every call.
    again = [svc.two_view(a, b, intr) for _ in range(2)]
    np.testing.assert_array_equal(again[0]["R"], again[1]["R"])
    assert again[0]["success"] and _rot_deg(again[0]["R"]) < 0.1


@pytest.mark.parametrize("shape", [(H, W), (90, 120), (200, 300), (37, 500),
                                   (120, 160, 3)])
def test_fit_bit_equal(services, shape):
    jax_svc, svc = services
    rng = np.random.default_rng(sum(shape))
    im = rng.uniform(0, 255, shape).astype(np.float32)
    (cj, sxj, syj), (cp, sxp, syp) = jax_svc._fit(im), svc._fit(im)
    np.testing.assert_array_equal(cp, cj)
    assert (sxp, syp) == (sxj, syj)


def test_letterbox_other_shapes(services, img):
    _, svc = services
    small = img[: H // 2, : W // 2]
    kp = svc.extract(small)
    v = kp["valid"]
    assert v.sum() >= 3
    assert (kp["x"][v] <= small.shape[1] + 1).all()
    assert (kp["y"][v] <= small.shape[0] + 1).all()


def test_strict_shape_rejects(img):
    svc = FeatureService(H, W, sift=SiftConfig(mode="lowe", octaves=2,
                                               max_keypoints=64,
                                               max_keypoints_per_octave=64),
                         strict_shape=True, device="cpu")
    with pytest.raises(ValueError):
        svc.extract(img[:50, :50])


def test_q8_rounds_half_to_even(services):
    """`_pack_kp` quantizes as the JAX service: round(d * 255) half to
    even, clamped."""
    _, svc = services
    from sift_tpu_torch.types import Keypoints
    d = torch.tensor([[0.5, 1.5, 2.5, 254.5, 255.5, -3.0, 300.0, 127.49]])
    z = torch.zeros(1, 1)
    kp = Keypoints(x=z, y=z, octave=z.int(), level=z.int(), scale=z,
                   score=z, orientation=z, valid=z.bool(),
                   desc=(d / 255.0)[:, None, :])
    _, q = svc._pack_kp(kp)
    want = np.clip(np.round(d.numpy() / np.float32(255.0) * 255.0), 0, 255)
    np.testing.assert_array_equal(q[0, 0].numpy(), want[0].astype(np.uint8))


def test_cuda_service_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FeatureService(H, W)


def _b64(arr) -> str:
    buf = io.BytesIO()
    Image.fromarray(np.asarray(arr).astype(np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _serve(service, handler):
    from http.server import ThreadingHTTPServer
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler(service))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    return None


def test_http_front(services, img):
    jax_svc, svc = services
    srv, t = _serve(svc, make_handler)
    jsrv, jt = _serve(jax_svc, jax_make_handler)
    port, jport = srv.server_address[1], jsrv.server_address[1]
    try:
        assert _get(port, "/healthz") == {"status": "ok", "shape": [H, W]}
        out = _post(port, "/extract", {"image": _b64(img)})
        assert out["n"] > 20 and len(out["x"]) == out["n"]
        assert set(out) == {"n", "x", "y", "scale", "octave", "orientation",
                            "score", "desc"}
        shifted = np.roll(img, 5, axis=1)
        out = _post(port, "/match", {"image_a": _b64(img),
                                     "image_b": _b64(shifted)})
        assert out["n"] > 15
        out = _post(port, "/twoview", {"image_a": _b64(img),
                                       "image_b": _b64(shifted)})
        assert set(out) == {"R", "t", "num_inliers", "success", "n_matches"}
        assert out["n_matches"] > 15
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/extract", {"image": "not-base64!!"})
        assert e.value.code == 400
        assert "error" in json.loads(e.value.read())
        st, jst = _get(port, "/stats"), _get(jport, "/stats")
        assert st["dispatch_stats"]["extract_requests"] >= 1
        assert st["phases"]["decode_s"]["n"] >= 1
        assert set(st) == set(jst)
        assert set(st["phases"]) == set(jst["phases"])
        assert set(st["dispatch_stats"]) == set(jst["dispatch_stats"])
    finally:
        srv.shutdown()
        jsrv.shutdown()
        t.join(timeout=30)
        jt.join(timeout=30)
    assert not t.is_alive() and not jt.is_alive()
