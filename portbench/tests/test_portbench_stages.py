"""The split of the traced window by the program's spans (`lib/stages.py`)
on synthetic events, counted by hand; the readers of the split with no
recording; and, on a card, a traced run of each cell at a small size."""

import dataclasses
import io
from typing import Optional

import pytest

from portbench.lib import cells, stages
from portbench.lib.context import Context
from portbench.tests.small import A, B, SEED, SHRINK

M = "spin_kernel"
READERS = ["dense_ms.pair", "dense_ms.extract", "keypoint_ms.pair",
           "keypoint_ms.extract", "ransac_syncs.pair", "extract_launches.pair"]


@dataclasses.dataclass
class S:
    name: str
    parent: int
    t0: int
    t1: Optional[int]
    thread: int = 7


def mark(t):
    return (f"void at::cuda::{M}(long)", t, t + 1)


# one step on the host (ns): the benchmark's extract span 0-100 holds the
# program's extract 10-90 with pyramid 20-40 and select 50-80; the
# benchmark's read span 100-120. The card lags the host (it runs the step
# from 200 on), so only the markers place its activities.
SPANS = [S("extract", -1, 10, 90), S("pyramid", 0, 20, 40),
         S("select", 0, 50, 80)]
BENCH = [(0, "extract", 0, 100), (0, "read", 100, 120)]
EVENTS = [mark(200),                         # enter extract
          ("copy_kernel", 202, 210),         # extract
          mark(211),                         # enter pyramid
          ("blur_fused_kernel", 212, 230),   # pyramid
          ("elementwise", 230, 240),         # pyramid
          mark(241),                         # exit pyramid
          ("Memcpy DtoH (Device -> Pageable)", 242, 244),   # extract
          mark(245),                         # enter select
          ("sort", 250, 270),                # select
          mark(271),                         # exit select
          mark(272)]                         # exit extract


def test_boundaries_of_nested_spans():
    spans = [S("a", -1, 0, 10), S("b", 0, 1, 4), S("c", 1, 2, 3),
             S("d", 0, 5, 9), S("e", -1, 11, 12)]
    assert stages.boundaries(spans, range(5)) == [
        (True, 0), (True, 1), (True, 2), (False, 2), (False, 1), (True, 3),
        (False, 3), (False, 0), (True, 4), (False, 4)]


def test_activities_go_to_the_span_open_at_their_marker():
    # the host window covers both host and card times
    sp = stages.split(EVENTS, BENCH, (0, 400), SPANS, 7, M, steps=1)
    assert sp.device_s[("extract",)] == pytest.approx(10e-9)
    assert sp.device_s[("extract", "pyramid")] == pytest.approx(28e-9)
    assert sp.device_s[("extract", "select")] == pytest.approx(20e-9)
    assert sp.device_s[(stages.MARKERS,)] == pytest.approx(6e-9)
    assert sp.launches == {("extract",): 2, ("extract", "pyramid"): 2,
                           ("extract", "select"): 1}
    assert sp.syncs == {("extract",): 1}
    assert sp.kernels[(("extract", "pyramid"), "blur_fused_kernel")] == \
        pytest.approx(18e-9)
    assert sp.markers == 6
    assert sp.leaf_ms(stages.DENSE) == pytest.approx(28e-6)
    assert sp.leaf_ms(stages.KEYPOINT) == pytest.approx(20e-6)
    assert sp.under(sp.launches, "extract") == 5
    assert sp.under(sp.syncs, "ransac") == 0
    assert sp.escaped == 0 and sp.coverage() == 1.0


def test_outside_every_program_span_the_benchmark_span_holds():
    # the program's extract span (15-35) in the benchmark's (0-36 on the
    # host): the markers put the trace -4 to 5 ahead (offset 0), so the
    # kernel at 8 ran at 3 to 12, in the benchmark's extract before the
    # program's
    bench = [(0, "extract", 0, 36), (0, "read", 36, 120)]
    events = [("k", 8, 10),                           # bench extract only
              mark(20), ("k", 25, 30), mark(31),      # program extract
              ("Memcpy DtoH (Device -> Pinned)", 105, 110),   # bench read
              ("k", 130, 135)]                        # no span at all
    spans = [S("extract", -1, 15, 35)]
    sp = stages.split(events, bench, (0, 140), spans, 7, M, steps=1)
    assert sp.offset_ns == (0, 0) and sp.crossed == 0
    assert sp.device_s[("extract",)] == pytest.approx(5e-9)
    assert sp.device_s[("[extract]",)] == pytest.approx(2e-9)
    assert sp.device_s[("[read]",)] == pytest.approx(5e-9)
    assert sp.device_s[(stages.BETWEEN,)] == pytest.approx(5e-9)
    assert sp.syncs == {("[read]",): 1}
    assert sp.escaped == 1                # in the benchmark's extract only
    assert sp.coverage() == pytest.approx(12 / 17)


def test_the_markers_bound_the_trace_clocks_offset():
    # the main step: the pyramid's entry marker starts 191 after the host
    # entered it, and extract's exit marker ends 173 after the benchmark's
    # extract span returned from its sync: the trace runs 173-190 ahead
    sp = stages.split(EVENTS, BENCH, (0, 400), SPANS, 7, M, steps=1)
    assert sp.offset_ns == (181, 181) and sp.crossed == 0


def test_a_trace_clock_that_lags_the_host_is_moved_forward():
    # the extract enter marker starts at 10 on the trace's clock, 5 before
    # the host entered the span (15), and the exit marker ends at 22, 14
    # before the benchmark span's sync returned (36): the offset is -10,
    # so the kernel at 95 ran at 105, in the benchmark's read span
    bench = [(0, "extract", 0, 36), (0, "read", 36, 120)]
    events = [mark(10), ("k", 15, 20), mark(21), ("k", 95, 99)]
    spans = [S("extract", -1, 15, 35)]
    sp = stages.split(events, bench, (0, 140), spans, 7, M, steps=1)
    assert sp.offset_ns == (-10, -10) and sp.escaped == 0
    assert sp.device_s[("[read]",)] == pytest.approx(4e-9)


def test_each_step_takes_its_own_offset():
    # the trace's clock drifts: step 0 runs 1-4 ahead, step 1 101-102
    bench = [(0, "extract", 0, 50), (0, "read", 50, 100),
             (1, "extract", 100, 150), (1, "read", 150, 200)]
    spans = [S("extract", -1, 10, 40), S("extract", -1, 110, 140)]
    events = [mark(14), ("k", 20, 30), mark(50),      # step 0's extract
              ("k", 55, 60),                          # step 0's read
              mark(212), ("k", 220, 240), mark(250),  # step 1's extract
              ("k", 255, 260)]                        # step 1's read
    sp = stages.split(events, bench, (0, 300), spans, 7, M, steps=2)
    assert sp.offset_ns == (2, 101) and sp.crossed == 0
    assert sp.width_ns == 3
    assert sp.device_s[("[read]",)] == pytest.approx(10e-9)
    assert sp.escaped == 0 and sp.coverage() == 1.0


@pytest.mark.parametrize("start, escaped", [(30, 0), (10, 1)])
def test_an_escape_counts_under_every_offset_the_bounds_allow(start,
                                                              escaped):
    # the offset lies in [-78, 1]: an activity outside the program's
    # extract span that starts at 30 may have run at 108, in the read span;
    # one that starts at 10 ran in the benchmark's extract span (9-88)
    events = [mark(16), ("k", 17, 20), mark(21), ("k", start, start + 2)]
    spans = [S("extract", -1, 15, 35)]
    sp = stages.split(sorted(events, key=lambda e: e[1]), BENCH, (0, 140),
                      spans, 7, M, steps=1)
    assert sp.offset_ns == (-39, -39) and sp.escaped == escaped


@pytest.mark.parametrize("low, high, want", [
    (None, None, 0), (-5, 7, 1), (3, 9, 6), (-9, -3, -6), (None, -4, -4),
    (4, None, 4), (6, 2, 4)])
def test_a_steps_offset_lies_between_its_bounds(low, high, want):
    assert stages._offset(low, high) == want


def test_idle_gaps_by_the_stage_that_ends_them():
    # the card idles 0-10 before extract's entry marker (the host had not
    # entered it), 14-30 before pyramid's exit marker, 34-60 before
    # select's and 62-100 after the step
    spans = [S("extract", -1, 5, 70), S("pyramid", 0, 8, 28),
             S("select", 0, 29, 65)]
    events = [mark(10), mark(11), ("k", 12, 14), mark(30), mark(31),
              ("k", 32, 34), mark(60), mark(61)]
    sp = stages.split(events, BENCH, (0, 100), spans, 7, M, steps=1)
    assert sp.idle_s == {("[extract]",): pytest.approx(48e-9),
                         ("extract", "pyramid"): pytest.approx(16e-9),
                         ("extract", "select"): pytest.approx(26e-9)}


def test_other_threads_and_spans_outside_the_window_are_left_out():
    spans = SPANS + [S("extract", -1, 30, 60, thread=8),
                     S("extract", -1, 500, 600)]
    sp = stages.split(EVENTS, BENCH, (0, 400), spans, 7, M, steps=1)
    assert sp.markers == 6 and sp.under(sp.launches, "extract") == 5


def test_markers_that_do_not_pair_off_refuse_a_split():
    with pytest.raises(stages.Unaligned):
        stages.split(EVENTS[:-1], BENCH, (0, 400), SPANS, 7, M, steps=1)


def _ctx(events):
    cell = cells.resolve(A)
    return Context(cell=cell.workload, config=cell.config,
                   traffic=cell.traffic, batch=2, steps=1, window_s=1.0,
                   latencies_s=[1.0], setup_s=1.0, spans=list(BENCH),
                   events=list(events), window_ns=(0, 400))


@pytest.mark.parametrize("name", READERS)
def test_readers_give_nothing_without_the_programs_recording(name,
                                                             monkeypatch):
    monkeypatch.setattr(stages, "_recording", lambda: (None, None))
    assert cells.load_module("metrics", name).read(_ctx(EVENTS)) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_nothing_where_the_split_fails(name, monkeypatch,
                                                    capsys):
    class Rec:
        spans = SPANS[:1]           # two boundaries against six markers
        marks = True
        allocator = []
    monkeypatch.setattr(stages, "_recording", lambda: (Rec, M))
    monkeypatch.setattr(stages.threading, "get_native_id", lambda: 7)
    assert cells.load_module("metrics", name).read(_ctx(EVENTS)) is None
    assert "stages: no split" in capsys.readouterr().err

    def broken(*a, **k):
        raise KeyError("unexpected")
    monkeypatch.setattr(stages, "report", broken)
    Rec.spans = SPANS
    assert cells.load_module("metrics", name).read(_ctx(EVENTS)) is None
    assert "KeyError: 'unexpected'" in capsys.readouterr().err


@pytest.mark.parametrize("name", READERS)
def test_readers_of_a_recording(name, monkeypatch, capsys):
    class Rec:
        spans = SPANS
        marks = True
        allocator = [{"num_device_alloc": 3}, {"num_device_alloc": 5}]
    monkeypatch.setattr(stages, "_recording", lambda: (Rec, M))
    monkeypatch.setattr(stages.threading, "get_native_id", lambda: 7)
    want = {"dense_ms.pair": 28e-6, "dense_ms.extract": 28e-6,
            "keypoint_ms.pair": 20e-6, "keypoint_ms.extract": 20e-6,
            "ransac_syncs.pair": 0, "extract_launches.pair": 5}[name]
    ctx = _ctx(EVENTS)
    assert cells.load_module("metrics", name).read(ctx) == \
        pytest.approx(want)
    err = capsys.readouterr().err
    assert "device_by_stage extract/pyramid" in err
    assert "in extract/pyramid: blur_fused_kernel" in err
    assert "num_device_alloc 2.000" in err
    cells.load_module("metrics", name).read(ctx)      # printed once a run
    assert capsys.readouterr().err == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", [A, B])
def test_a_traced_run_splits_by_stage_on_the_card(cell, card, capsys):
    from portbench.lib import harness
    out = harness.run(cell, SEED, 0, True, "cuda", overrides=SHRINK[cell],
                      steps=3, log=io.StringIO())
    got = out.line["metrics"]
    for m in READERS:
        if not m.endswith(".pair" if cell == A else ".extract"):
            continue
        assert m in got, (m, sorted(got))
    assert out.ok
    err = capsys.readouterr().err
    assert "run in a benchmark extract span outside the program's: 0" in err
