"""The frozen reference against the port's plain CPU path on small
images: the same keypoints and descriptors, and the same matches and
homography on a warped pair. The control (bfloat16 pyramid, TF32
products, float32 fits) must not be."""

import pytest
import torch

import sift_tpu_torch as port
from sift_tpu_torch.geometry.homography import ransac_homography
from sift_tpu_torch.matching.matcher import match_descriptors, matched_coords

from portbench.inputs import warped_pairs
from portbench.lib.compare import counterparts, desc_gap
from portbench.lib.seeds import generator
from portbench.reference import homography, matching, sift_lowe
from portbench.steps.pair import gumbel

CFG = {"sigma": 1.6, "k": 1.4142135623730951, "octaves": 4,
       "dogs_per_epoch": 3, "subpixel": False, "mode": "lowe",
       "max_keypoints_per_octave": 256, "max_keypoints": 256,
       "contrast_threshold": 0.03, "edge_r": 10.0, "ori_peak_rel": 0.8,
       "descriptor_max_component": 0.2, "rootsift": False,
       "image_max": 255.0, "pallas": "auto", "window_dtype": "bfloat16",
       "extrema_topk": "exact"}
MATCH = {"ratio": 0.8, "mutual": True, "max_matches": 256, "metric": "l2",
         "impl": "auto"}
RANSAC = {"num_hypotheses": 64, "inlier_threshold": 3.0, "min_inliers": 15,
          "refit": True, "essential_solver": "5pt"}
SPEC = {"pairs": 1, "rotation_deg": 6.0, "scale": [0.9, 1.0],
        "shift_px": 10.0, "perspective": 1e-5, "fill": 128.0}


def scene():
    torch.set_num_threads(1)
    return warped_pairs.make(SPEC, 112, 144, 77, "cpu")


COLMAP = {**CFG, "subpixel": True, "rootsift": True}


def port_pair(s, cfg=CFG):
    kp = port.extract_batch(s.frames, port.SiftConfig(**cfg), device="cpu")
    m = match_descriptors(kp.desc[0], kp.valid[0], kp.desc[1], kp.valid[1],
                          port.MatchConfig(**MATCH))
    return kp, m


def as_dict(kp):
    return {f: getattr(kp, f) for f in sift_lowe.FIELDS + ("desc",)}


@pytest.mark.parametrize("cfg", [CFG, COLMAP], ids=["plain", "subpixel_rootsift"])
def test_extraction_agrees_with_the_port(cfg):
    s = scene()
    kp, _ = port_pair(s, cfg)
    prog = as_dict(kp)
    ref = sift_lowe.extract(s.frames, cfg)
    for b in range(2):
        miss, ref_of = counterparts({k: v[b] for k, v in prog.items()},
                                    {k: ref[k][b] for k in prog}, "cpu")
        assert miss == 0.0
        assert int(kp.valid[b].sum()) > 20
        assert desc_gap(prog["desc"][b], ref["desc"][b], ref_of) < 1e-5
    v = prog["valid"]
    assert torch.equal(prog["x"][v], ref["x"][v])
    if cfg["rootsift"]:
        sq = (ref["desc"][ref["valid"]] ** 2).sum(-1)
        assert torch.allclose(sq, torch.ones_like(sq), atol=1e-5)


def test_upsampling_doubles_bilinearly():
    from sift_tpu_torch.kernels.resize import resize_bilinear
    x = torch.rand(2, 5, 7) * 255.0
    up = sift_lowe.upsample2(x)
    assert torch.equal(up, resize_bilinear(x, 10, 14))
    assert torch.equal(up[:, 0, 0], x[:, 0, 0])
    assert torch.equal(up[:, 0, 1], x[:, 0, 0] * 0.75 + x[:, 0, 1] * 0.25)
    assert torch.equal(up[:, 0, 2], x[:, 0, 0] * 0.25 + x[:, 0, 1] * 0.75)


def test_matches_and_homography_agree_with_the_port():
    s = scene()
    kp, m = port_pair(s)
    ref = matching.match(kp.desc[0], kp.valid[0], kp.desc[1], kp.valid[1],
                         MATCH)
    assert torch.equal(ref["idx_a"][ref["valid"]].to(torch.int32),
                       m.idx_a[m.valid])
    assert torch.equal(ref["idx_b"][ref["valid"]].to(torch.int32),
                       m.idx_b[m.valid])
    noise = gumbel((RANSAC["num_hypotheses"], MATCH["max_matches"]),
                   generator(3, "t"), "cpu")
    pa, pb, ok = matched_coords(kp.map(lambda t: t[0]),
                                kp.map(lambda t: t[1]), m)
    est = ransac_homography(noise, pa, pb, ok, port.RansacConfig(**RANSAC))
    H, n = homography.ransac(noise, pa, pb, ok, RANSAC)
    assert torch.equal(H, est.model) and int(n) == int(est.num_inliers)


def test_the_control_departs():
    s = scene()
    exact = sift_lowe.extract(s.frames, CFG)
    ctrl = sift_lowe.extract(s.frames, CFG, sift_lowe.CONTROL)
    miss, _ = counterparts({k: exact[k][0] for k in sift_lowe.FIELDS},
                           {k: ctrl[k][0] for k in sift_lowe.FIELDS}, "cpu")
    assert miss > 0.5
    g = torch.Generator().manual_seed(5)
    wins = torch.randn((64, 2, 48, 48), generator=g) * 20.0
    off = torch.rand((64,), generator=g) - 24.5
    peaks = torch.rand((64, 2), generator=g) * 360.0
    sw = torch.full((64,), 2.0)
    one, low = (sift_lowe.descriptors(wins, off, off, peaks, sw, CFG, p)
                for p in (sift_lowe.EXACT, sift_lowe.CONTROL))
    assert float((one - low).abs().max()) > 1e-5      # sound: ~2e-7


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0])
    r = sift_lowe.tf32(x)
    assert r.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
