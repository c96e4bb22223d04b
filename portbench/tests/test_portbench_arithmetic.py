"""The yardstick's arithmetic on small cases counted by hand: the work
formulas, the 95th percentile of all samples, the union of device
intervals and its gaps."""

import math

import pytest

from portbench.lib import stats, work

SIFT = {"sigma": 1.6, "k": math.sqrt(2.0), "octaves": 2, "dogs_per_epoch": 3}


def test_gaussian_taps():
    assert work.gaussian_taps(1.0) == 7          # radius 3
    assert work.gaussian_taps(1.249) == 9        # round(3.747) = 4
    assert work.gaussian_taps(0.1) == 3          # radius at least 1


def test_blur_work_by_hand():
    # base blur sqrt(1.6^2 - 0.5^2) = 1.5199 -> radius 5, 11 taps; the
    # octave's blurs 1.6 -> 2.263 -> 3.2 -> 4.525: increments 1.6, 2.263,
    # 3.2 -> radii 5, 7, 10 -> 11, 15, 21 taps; octaves 8x10 and 4x5
    b, o = work.blur_work(SIFT, 8, 10, batch=3)
    n0, n1 = 3 * 80, 3 * 20
    taps = [11, 15, 21]
    assert b == pytest.approx(8 * (n0 + 3 * n0 + 3 * n1))
    assert o == pytest.approx(2 * (n0 * 21 + sum((n0 + n1) * (2 * t - 1)
                                                  for t in taps)))


def test_blur_work_of_a_doubled_input_by_hand():
    # subpixel: the 8x10 input doubled to 16x20, taken as blurred by 1.0:
    # base blur sqrt(1.6^2 - 1) = 1.249 -> radius 4, 9 taps; octaves
    # 16x20 and 8x10, the octave's blurs as above
    b, o = work.blur_work({**SIFT, "subpixel": True}, 8, 10, batch=3)
    n0, n1 = 3 * 320, 3 * 80
    taps = [11, 15, 21]
    assert b == pytest.approx(8 * (n0 + 3 * n0 + 3 * n1))
    assert o == pytest.approx(2 * (n0 * 17 + sum((n0 + n1) * (2 * t - 1)
                                                  for t in taps)))


def test_octave_sizes_round_up():
    assert work.octave_sizes(5, 7, 3) == [(5, 7), (3, 4), (2, 2)]


def test_descriptor_work_by_hand():
    b, o = work.descriptor_work(windows=2, orientations=3)
    assert b == 2 * 2 * 2304 * 4 + 3 * 128 * 4
    assert o == 2 * 2304 * 20 + 3 * 2304 * 62


def test_top2_work_by_hand():
    assert work.top2_work(3, 5) == ((3 + 5) * 128 * 4, 2 * 3 * 5 * 128)


def test_bound_takes_the_larger_wall():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 67e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e12, 134e12) == pytest.approx(2.0)


def test_p95_of_all_samples():
    assert stats.p95(list(range(1, 101))) == 95
    assert stats.p95([5.0]) == 5.0
    assert stats.p95([3, 1, 2]) == 3                 # rank ceil(2.85) = 3
    assert stats.p95(list(range(20, 0, -1))) == 19   # rank 19 of 20


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert stats.union_length(iv) == pytest.approx(3 + 1 + 1)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert stats.gaps([], 1, 2) == [(1, 2)]
    assert stats.union_length([]) == 0.0


def _kp(xs, ori=0.0):
    import torch
    n = len(xs)
    return {"x": torch.tensor(xs, dtype=torch.float32), "y": torch.zeros(n),
            "octave": torch.zeros(n, dtype=torch.int32),
            "level": torch.ones(n, dtype=torch.int32),
            "orientation": torch.full((n,), ori),
            "valid": torch.ones(n, dtype=torch.bool)}


def test_counterparts_by_hand():
    from portbench.lib.compare import counterparts, match_miss
    import torch
    # 3 program keypoints and 2 reference ones: x = 5 has no counterpart
    miss, ref_of = counterparts(_kp([0.0, 1.0, 5.0]), _kp([0.005, 1.0]), "cpu")
    assert miss == 1 / 5 and ref_of.tolist() == [0, 1, -1]
    # 359.96 deg lies 0.09 deg from 0.05 around the circle
    miss, _ = counterparts(_kp([0.0], 359.96), _kp([0.0], 0.05), "cpu")
    assert miss == 0.0
    empty = {k: v[:0] for k, v in _kp([0.0]).items()}
    assert counterparts(_kp([0.0, 1.0]), empty, "cpu")[0] == 1.0
    pairs = torch.tensor([[0, 1], [2, -1]])
    assert match_miss(pairs, torch.tensor([[0, 1], [3, 3]])) == 2 / 4


def test_kernel_short_names():
    from portbench.lib.tracing import short_name
    assert short_name("(anonymous namespace)::top2_kernel(float const*, "
                      "int)") == "(anonymous namespace)::top2_kernel"
    assert short_name("void (anonymous namespace)::blur_line_kernel(float "
                      "const*, float*)") == \
        "(anonymous namespace)::blur_line_kernel"
    assert short_name("void at::native::f<4, (int)2>(int)") == \
        "at::native::f<4, (int)2>"
    assert short_name("Memcpy DtoH") == "Memcpy DtoH"
