"""`correct` on the CPU at small sizes: true for the program as it is,
false for the control (the reference at the precision below the stated
one in the program's place) and for each fault a cell can have, planted
under the timed path: a step that returns its state unchanged, half of a
batch left out (the rest repeated in its place), and an answer altered
where it is produced. The cells run on one chip, so no exchange between
chips can be left out."""

import dataclasses

import pytest
import torch

import sift_tpu_torch
from sift_tpu_torch.geometry import homography as port_h
from sift_tpu_torch.matching import matcher as port_m

from portbench.lib import cells, harness
from portbench.reference.sift_lowe import CONTROL, CONTROL_TF32
from portbench.tests.small import A, B, SEED, SHRINK


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(cell, **kw):
    return harness.run(cell, SEED, 0, False, "cpu", overrides=SHRINK[cell],
                       steps=3, **kw)


@pytest.mark.parametrize("cell", [A, B])
def test_the_program_is_correct(cell):
    out = run(cell)
    assert out.ok, out.checks
    assert out.line["correct"] is True and out.line["attempted"] == 3


@pytest.mark.parametrize("cell", [A, B])
def test_the_control_is_not(cell):
    c = cells.resolve(cell, overrides=SHRINK[cell])
    judge = cells.load_module("judges", c.step_kind)
    out = run(cell, program=lambda inputs: judge.reference(c.config, inputs,
                                                           CONTROL))
    assert not out.ok
    assert out.checks["kp_miss"]["value"] > c.limits["kp_miss"]
    low = run(cell, program=lambda inputs: judge.reference(c.config, inputs,
                                                           CONTROL_TF32))
    assert not low.ok
    assert low.checks["kp_miss"]["value"] == 0.0
    assert low.checks["desc_gap"]["value"] > c.limits["desc_gap"]


def stale(extract):
    first = []

    def f(imgs, *a, **k):
        if not first:
            first.append(extract(imgs, *a, **k))
        return first[0]
    return f


def previous(extract):
    """Each call answers with the call before it (the first with its own)."""
    last = []

    def f(imgs, *a, **k):
        kp = extract(imgs, *a, **k)
        out = last[0] if last else kp
        last[:] = [kp]
        return out
    return f


def half_batch(extract):
    def f(imgs, *a, **k):
        h = imgs.shape[0] // 2
        kp = extract(imgs[:h], *a, **k)
        return kp.map(lambda t: torch.cat([t, t]))
    return f


def altered_descriptor(extract):
    def f(imgs, *a, **k):
        kp = extract(imgs, *a, **k)
        desc = kp.desc.clone()
        b, n = torch.nonzero(kp.valid, as_tuple=True)
        desc[b[0], n[0], 0] += 0.01
        return dataclasses.replace(kp, desc=desc)
    return f


def altered_position(extract):
    def f(imgs, *a, **k):
        kp = extract(imgs, *a, **k)
        x = kp.x.clone()
        b, n = torch.nonzero(kp.valid, as_tuple=True)
        x[b[0], n[0]] += 0.5
        return dataclasses.replace(kp, x=x)
    return f


EXTRACT_FAULTS = {"stale": stale, "previous": previous,
                  "half_batch": half_batch,
                  "altered_descriptor": altered_descriptor,
                  "altered_position": altered_position}


@pytest.mark.parametrize("cell", [A, B])
@pytest.mark.parametrize("fault", sorted(EXTRACT_FAULTS))
def test_extraction_faults(monkeypatch, cell, fault):
    monkeypatch.setattr(sift_tpu_torch, "extract_batch",
                        EXTRACT_FAULTS[fault](sift_tpu_torch.extract_batch))
    out = run(cell)
    assert not out.ok, (fault, out.checks)


@pytest.mark.parametrize("cell", [A, B])
@pytest.mark.parametrize("fault", ["stale", "previous"])
@pytest.mark.parametrize("seed", [1, 2**31 + 7, 2**32 + 3, 9_000_000_011])
def test_stale_answers_fail_on_every_seed(monkeypatch, cell, fault, seed):
    """Whatever steps a seed draws for the check, they hold two scene
    items, so an answer that stays or lags behind its input is seen."""
    monkeypatch.setattr(sift_tpu_torch, "extract_batch",
                        EXTRACT_FAULTS[fault](sift_tpu_torch.extract_batch))
    out = harness.run(cell, seed, 0, False, "cpu", overrides=SHRINK[cell],
                      steps=5)
    assert not out.ok, (seed, out.checks)


def test_the_check_covers_two_items():
    rng = __import__("random").Random(3)
    kept = {t: (t, None, None) for t in range(8)}
    for _ in range(50):
        got = harness.choose_kept(kept, 2, rng)
        assert len({k[0] for k in got}) == 2


def altered_match(match):
    def f(*a, **k):
        m = match(*a, **k)
        idx_b = m.idx_b.clone()
        i = int(torch.nonzero(m.valid)[0])
        idx_b[i] = (idx_b[i] + 1) % (a[2].shape[0])
        return dataclasses.replace(m, idx_b=idx_b)
    return f


def altered_distance(match):
    def f(*a, **k):
        m = match(*a, **k)
        d = m.distance.clone()
        d[int(torch.where(m.valid, d, -1.0).argmax())] *= 1.01
        return dataclasses.replace(m, distance=d)
    return f


def altered_homography(ransac):
    def f(*a, **k):
        est = ransac(*a, **k)
        model = est.model.clone()
        model[0, 2] += 0.05
        return dataclasses.replace(est, model=model)
    return f


PAIR_FAULTS = {"idx_b": (port_m, "match_descriptors", altered_match),
               "distance": (port_m, "match_descriptors", altered_distance),
               "H": (port_h, "ransac_homography", altered_homography)}


@pytest.mark.parametrize("fault", sorted(PAIR_FAULTS))
def test_pair_answer_faults(monkeypatch, fault):
    mod, name, plant = PAIR_FAULTS[fault]
    monkeypatch.setattr(mod, name, plant(getattr(mod, name)))
    out = run(A)
    assert not out.ok, out.checks
