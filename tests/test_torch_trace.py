"""The port's span recorder (`sift_tpu_torch/utils/metrics.py`) and the
spans it places in extraction, matching and RANSAC, on the CPU.

Off, `stage` records nothing and opens no profiler range; on, each span
keeps its name, parent, thread, entry and exit times, fields and counters;
a torch profiler session gets a recording of its own. The program's
outputs are bit-identical with the recorder on and off.
"""

import threading

import numpy as np
import pytest
import torch

from sift_tpu_torch.config import MatchConfig, RansacConfig, SiftConfig
from sift_tpu_torch.frontend.sift import extract_batch
from sift_tpu_torch.geometry.homography import ransac_homography
from sift_tpu_torch.matching.matcher import match_descriptors
from sift_tpu_torch.utils import metrics
from tests.torch_dist_world import one_torch_thread  # noqa: F401

OCTAVE_STAGES = ["extrema", "refine", "gradients", "orientation", "descriptor"]


def _forbid_ranges(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function opened")
    monkeypatch.setattr(torch.profiler, "record_function", boom)


def _tree(rec):
    """(name, parent name or None, fields) of every span, in entry order."""
    return [(s.name, rec.spans[s.parent].name if s.parent >= 0 else None,
             s.fields) for s in rec.spans]


def _assert_well_nested(rec):
    """Children lie within their parent; siblings follow one another."""
    last_child = {}
    for i, s in enumerate(rec.spans):
        assert s.t1 is not None and s.t0 <= s.t1
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1 and s.thread == p.thread
        prev = last_child.get(s.parent)
        if prev is not None:
            assert rec.spans[prev].t1 <= s.t0
        last_child[s.parent] = i


def _equal(a, b):
    """Every tensor field of two results the same, bit for bit."""
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                                       msg=f)
        else:
            assert (x is None) == (y is None), f


@pytest.mark.parametrize("case", ["plain", "fields", "logger"])
def test_off_records_nothing_and_opens_no_range(case, monkeypatch):
    _forbid_ranges(monkeypatch)
    before = metrics.profiled()
    fields = {"B": 2, "octave": 1} if case == "fields" else {}
    ctx = metrics.stage("extract", **fields)
    assert ctx is metrics.stage("other")          # one shared null context
    with ctx:
        with metrics.stage("inner"):
            metrics.count("n", 3)
    assert metrics.profiled() is before
    if case == "logger":
        seen = []

        class Log:
            def log(self, event, **f):
                seen.append((event, f["name"]))
        with metrics.stage("extract", Log()):
            pass
        assert seen == [("stage", "extract")]


@pytest.mark.parametrize("threads", [1, 3])
def test_on_records_nesting_fields_threads_and_counts(threads, monkeypatch):
    _forbid_ranges(monkeypatch)              # no profiler runs: no range

    def work(tag):
        with metrics.stage("outer", tag=tag):
            metrics.count("calls")
            with metrics.stage("inner", tag=tag):
                metrics.count("items", 5)
                metrics.count("items", 2)
            metrics.count("calls")
            with metrics.stage("second"):
                pass

    with metrics.recording() as rec:
        ts = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
    assert len(rec.spans) == 3 * threads
    by_thread = {}
    for s in rec.spans:
        by_thread.setdefault(s.thread, []).append(s)
    assert len(by_thread) == threads
    for spans in by_thread.values():
        outer, inner, second = spans
        assert [s.name for s in spans] == ["outer", "inner", "second"]
        assert outer.parent == -1
        assert rec.spans[inner.parent] is outer
        assert rec.spans[second.parent] is outer
        assert inner.fields == outer.fields and second.fields == {}
        assert outer.counts == {"calls": 2} and inner.counts == {"items": 7}
        assert second.counts == {}
    _assert_well_nested(rec)
    assert metrics.stage("after") is metrics.stage("after2")   # off again


def test_a_profiler_session_gets_a_recording():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.stage("outer", k=1):
            with metrics.stage("inner"):
                torch.ones(4, 4) @ torch.ones(4, 4)
    rec = metrics.profiled()
    assert [(s.name, s.parent, s.fields) for s in rec.spans] == \
        [("outer", -1, {"k": 1}), ("inner", 0, {})]
    assert rec.profiler and not rec.marks        # no CUDA: no markers
    names = {e.key for e in prof.key_averages()}
    assert {"outer", "inner"} <= names
    with metrics.stage("later"):                 # the session has ended
        pass
    assert metrics.profiled() is rec and len(rec.spans) == 2
    assert metrics.stage("x") is metrics.stage("y")


@pytest.mark.parametrize("cuda", [False, True])
def test_a_profiler_session_marks_boundaries_where_cuda_runs(cuda,
                                                             monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    order = []
    monkeypatch.setattr(metrics, "_mark", lambda: order.append("mark"))
    with profile(activities=[ProfilerActivity.CPU]):
        with monkeypatch.context() as m:
            m.setattr(metrics.torch.cuda, "is_initialized", lambda: cuda)
            m.setattr(metrics.torch.cuda, "memory_stats",
                      lambda: {"num_device_alloc": 4 + len(order)})
            with metrics.stage("a"):
                order.append("a")
                with metrics.stage("b"):
                    order.append("b")
    want = ["mark", "a", "mark", "b", "mark", "mark"]
    assert order == (want if cuda else ["a", "b"])
    rec = metrics.profiled()
    assert rec.marks == cuda and [s.name for s in rec.spans] == ["a", "b"]
    with monkeypatch.context() as m:
        m.setattr(metrics.torch.cuda, "is_initialized", lambda: cuda)
        m.setattr(metrics.torch.cuda, "memory_stats",
                  lambda: {"num_device_alloc": 4 + len(order)})
        with metrics.stage("later"):             # ends the recording
            pass
    counts = {"num_device_alloc": 4, "num_device_free": 0,
              "num_alloc_retries": 0}
    assert rec.allocator == ([counts, {**counts, "num_device_alloc": 10}]
                             if cuda else [])


def _images(b=2, h=64, w=80, seed=0):
    g = torch.Generator().manual_seed(seed)
    img = torch.rand((b, h, w), generator=g) * 255.0
    # a few bright blobs give the detector something to find
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    for cy, cx, r in ((20, 25, 3.0), (40, 55, 4.0), (30, 40, 2.5)):
        img += 200.0 * torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / r ** 2)
    return img.clamp(0, 255)


@pytest.mark.parametrize("cfg", [SiftConfig(),
                                 SiftConfig(subpixel=True, rootsift=True)],
                         ids=["default", "subpixel-rootsift"])
def test_extract_spans_and_outputs(cfg, one_torch_thread):  # noqa: F811
    imgs = _images()
    plain = extract_batch(imgs, cfg, device="cpu")
    with metrics.recording() as rec:
        got = extract_batch(imgs, cfg, device="cpu")
    _equal(plain, got)
    assert int(got.valid.sum()) > 0
    tree = _tree(rec)
    assert tree[0] == ("extract", None, {"B": 2, "H": 64, "W": 80,
                                         "mode": "lowe"})
    assert tree[1] == ("pyramid", "extract", {})
    assert tree[-1] == ("select", "extract", {})
    per_octave = tree[2:-1]
    n = len(per_octave) // len(OCTAVE_STAGES)
    assert n >= 2 and len(per_octave) == n * len(OCTAVE_STAGES)
    assert per_octave == [(s, "extract", {"octave": o})
                          for o in range(n) for s in OCTAVE_STAGES]
    _assert_well_nested(rec)


def test_parity_span(one_torch_thread):  # noqa: F811
    cfg = SiftConfig(mode="parity")
    imgs = _images(b=1)
    plain = extract_batch(imgs, cfg, device="cpu")
    with metrics.recording() as rec:
        got = extract_batch(imgs, cfg, device="cpu")
    _equal(plain, got)
    assert [(n, p) for n, p, _ in _tree(rec)] == [("extract", None),
                                                  ("parity", "extract")]


def _descriptors(seed, n=300, d=128):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand((n, d), generator=g)
    b = a[torch.randperm(n, generator=g)] + 0.01 * torch.rand((n, d),
                                                              generator=g)
    va = torch.rand(n, generator=g) > 0.1
    vb = torch.rand(n, generator=g) > 0.1
    return a, va, b, vb


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("mutual", [False, True])
def test_match_spans_and_outputs(impl, mutual):
    a, va, b, vb = _descriptors(3)
    cfg = MatchConfig(impl=impl, mutual=mutual, max_matches=256)
    plain = match_descriptors(a, va, b, vb, cfg)
    with metrics.recording() as rec:
        got = match_descriptors(a, va, b, vb, cfg)
    _equal(plain, got)
    assert int(got.valid.sum()) > 100
    assert [(n, p) for n, p, _ in _tree(rec)] == \
        [("match", None), ("top2", "match"), ("accept", "match")]
    _assert_well_nested(rec)


@pytest.mark.parametrize("refit", [False, True])
def test_ransac_spans_and_outputs(refit):
    g = torch.Generator().manual_seed(5)
    n = 400
    pa = torch.rand((n, 2), generator=g) * 500
    h = torch.tensor([[1.02, 0.03, 4.0], [-0.02, 0.98, -3.0],
                      [1e-5, 2e-5, 1.0]])
    q = torch.cat([pa, torch.ones(n, 1)], 1) @ h.T
    pb = q[:, :2] / q[:, 2:]
    pb[::5] += torch.rand((n // 5 + (n % 5 > 0), 2), generator=g) * 80
    valid = torch.ones(n, dtype=torch.bool)
    valid[-20:] = False
    noise = -torch.log(-torch.log(torch.rand((256, n), generator=g)
                                  .clamp_min(1e-30)))
    cfg = RansacConfig(inlier_threshold=3.0, num_hypotheses=256, refit=refit)
    plain = ransac_homography(noise, pa, pb, valid, cfg)
    with metrics.recording() as rec:
        got = ransac_homography(noise, pa, pb, valid, cfg)
    _equal(plain, got)
    assert bool(got.success)
    want = ["sample", "solve", "score"] + (["refit"] if refit else [])
    assert [(n_, p) for n_, p, _ in _tree(rec)] == \
        [("ransac", None)] + [(s, "ransac") for s in want]
    _assert_well_nested(rec)


def test_stage_off_is_cheap():
    """The off path is one check and a shared null context: well under a
    microsecond on an idle host (PERF.md); the bound here is 5 us, for a
    host loaded by parallel test workers."""
    import time
    n = 20000
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(n):
            with metrics.stage("x"):
                pass
        best = min(best, (time.perf_counter() - t) / n)
    assert best < 5e-6
    assert np.isfinite(best)
