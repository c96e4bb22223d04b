"""The port's roofline and timing modules (`sift_tpu_torch/utils/roofline.py`,
`utils/timing.py`).

`roofline` must give the JAX package's dict on the same numbers and
peaks; `kernel_work` counts each hand kernel's bytes (each input read
once, each output written once) and operations at small shapes, checked
here against the formulas worked by hand. The timing functions measure
only the card and refuse without one.
"""

import numpy as np
import pytest
import torch

from sift_tpu.utils.roofline import roofline as jax_roofline

from sift_tpu_torch.kernels.gaussian import gaussian_kernel_1d
from sift_tpu_torch.utils import roofline as rl
from sift_tpu_torch.utils import timing
from tests.torch_dist_world import one_torch_thread  # noqa: F401

CASES = [  # name, seconds, flops, bytes
    ("bytes-bound", 1.2e-3, 3.0e9, 4.0e9),
    ("ops-bound", 2.5e-2, 9.0e14, 1.0e6),
    ("zero-time", 0.0, 1.0, 0.0),
    ("tiny", 3.7e-6, 1234.5, 678.9),
]
PEAKS = [(rl.H100_PEAK_FLOPS_BF16, rl.H100_HBM_BYTES_S),
         (rl.H100_PEAK_FLOPS_TF32, rl.H100_HBM_BYTES_S),
         (rl.H100_PEAK_FLOPS_F32, rl.H100_HBM_BYTES_S)]


@pytest.mark.parametrize("peaks", PEAKS, ids=["bf16", "tf32", "f32"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_roofline_equals_jax(case, peaks):
    assert rl.roofline(*case, *peaks) == jax_roofline(*case, *peaks)


def test_roofline_defaults_are_the_h100_bf16_peaks():
    case = CASES[0]
    assert rl.roofline(*case) == jax_roofline(*case, 989e12, 3.35e12)


def test_peaks_are_the_data_sheet_numbers():
    assert (rl.H100_PEAK_FLOPS_BF16, rl.H100_PEAK_FLOPS_TF32,
            rl.H100_PEAK_FLOPS_F32, rl.H100_HBM_BYTES_S) == \
        (989e12, 495e12, 67e12, 3.35e12)


def test_bound_ms_names_the_wall():
    assert rl.bound_ms(3.35e9, 0.0) == (1.0, "bytes")
    ms, by = rl.bound_ms(1.0, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_work_of_the_window_gather():
    maps = torch.zeros((2, 3, 40, 50), dtype=torch.bfloat16)
    K, d = 7, 48
    z = torch.zeros(K, dtype=torch.int32)
    assert rl.kernel_work("gather_windows", (maps, z, z, z, d)) == \
        (K * 2 * d * d * (2 + 4) + K * 12, 0.0)


def test_work_of_the_descriptor():
    K, d = 5, 30
    wins, scal = torch.zeros((K, 2, d, d)), torch.zeros((K, 9))
    assert rl.kernel_work("descriptor_accumulate", (wins, scal)) == \
        (K * (2 * d * d * 4 + 9 * 4 + 2 * 128 * 4), K * d * d * 144.0)


def test_work_of_the_streaming_top2():
    a, b = torch.zeros((6, 128)), torch.zeros((9, 128))
    va, vb = torch.ones(6, dtype=torch.bool), torch.ones(9, dtype=torch.bool)
    assert rl.kernel_work("streaming_top2", (a, va, b, vb)) == \
        ((6 + 9) * (128 * 4 + 1) + 6 * 12, 2.0 * 6 * 9 * 128)


def test_work_of_the_blur():
    img, taps = torch.zeros((2, 5, 7)), gaussian_kernel_1d(1.6)
    assert len(taps) == 11
    assert rl.kernel_work("blur", (img, taps)) == (70 * 4 * 2.0,
                                                   70 * 2.0 * 21)


def test_work_of_the_refine_walk():
    """One keypoint in the middle of a flat DoG stack: the walk does not
    move, so it reads the 27-cell cube at its start twice (the first step
    and the final read), 27 distinct cells; its patch covers 16x16 cells
    of each of the L levels."""
    B, L, H, W = 1, 4, 40, 48
    dogs = torch.zeros((B, L, H, W))
    x = torch.tensor([[20.0]])
    y = torch.tensor([[17.0]])
    level = torch.tensor([[1]], dtype=torch.int32)
    assert rl.walk_cells(dogs, x, y, level) == 27
    assert rl.covered_cells(dogs, x, y) == 16 * 16 * L
    assert rl.kernel_work("refine_walk", (dogs, x, y, level)) == \
        (27 * 4 + 1 * (12 + 27 * 4 + 16), 6 * 150.0)


def test_work_of_an_unknown_kernel_is_refused():
    with pytest.raises(ValueError):
        rl.kernel_work("conv", ())


@pytest.mark.parametrize("call", [
    lambda: timing.event_ms(lambda: None, 3),
    lambda: timing.kernel_trace(lambda: None, "k", 3),
    lambda: timing.busy_share(lambda: None),
], ids=["event_ms", "kernel_trace", "busy_share"])
def test_timing_needs_the_card(call, monkeypatch):
    """No host-clock stand-in: without CUDA each function raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.mark.parametrize("launches,seen,want", [
    (1, {0.0: 5, 2.5: 5}, (2.0, 1.0, 0.0, [0.0])),    # whole at once
    (1, {0.0: 3, 2.5: 5}, (2.0, 1.0, 2.5, [0.0, 2.5])),  # two records late
    (1, {0.0: 0, 2.5: 0, 5.0: 4}, (None, 0.8, 5.0, [0.0, 2.5, 5.0])),
    (None, {0.0: 9, 2.5: 10}, (2.0, 2.0, 2.5, [0.0, 2.5])),  # two a call
    (2, {0.0: 5, 2.5: 10}, (2.0, 2.0, 2.5, [0.0, 2.5])),  # 5: whole for 1
])
def test_whole_trace_waits_until_every_launch_shows(launches, seen, want):
    """`kernel_trace`'s repair of CUPTI's late records: a session whose
    trace lacks a launch of its calls is taken again with the next wait
    before it stops, and a time is only ever the mean of a whole trace."""
    waits = []

    def session(wait):
        waits.append(wait)
        return (10000.0 if seen[wait] else 0.0), seen[wait]
    ms, per_call, wait = timing.whole_trace(session, 5, launches)
    assert (ms, per_call, wait, waits) == want


def test_roofline_of_a_measured_time():
    """`roofline` fed `kernel_work`'s counts: a blur of 8 x 488x600 in 1 ms
    moves 18.7 MB, 0.56% of the HBM peak in that time."""
    img, taps = torch.zeros((8, 488, 600)), gaussian_kernel_1d(1.6)
    nbytes, ops = rl.kernel_work("blur", (img, taps))
    r = rl.roofline("blur", 1e-3, ops, nbytes, rl.H100_PEAK_FLOPS_F32)
    assert r["gbytes"] == round(nbytes / 1e9, 3)
    assert r["pct_peak_hbm"] == round(100 * nbytes / 1e-3 / 3.35e12, 1)
    assert r["bound"] == "memory"
    np.testing.assert_allclose(nbytes, 8 * 488 * 600 * 8)
