"""Parity-mode and subpixel stages of the PyTorch port against the JAX
package, each fed the same seeded inputs (the later stages JAX's own
intermediate products).

Exact selections, integer fields and validity agree bit for bit; the
blur sums in another f32 order than XLA's, so pyramid values agree to
1e-5 of the largest magnitude.
"""

import functools

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax
import jax.numpy as jnp

from sift_tpu.config import SiftConfig as JaxSiftConfig
from sift_tpu.frontend import orientation as jax_ori
from sift_tpu.frontend import parity as jax_parity
from sift_tpu.frontend.extrema import detect_extrema_octave as jax_detect
from sift_tpu.frontend.pyramid import build_pyramid as jax_build_pyramid
from sift_tpu.frontend.pyramid import parity_sigma_schedule as jax_schedule
from sift_tpu.frontend.refine import refine_octave_parity as jax_refine
from sift_tpu.kernels import resize as jax_resize
from sift_tpu.kernels.derivatives import scale_space_gradient_hessian as jax_sgh
from sift_tpu.kernels.dog import dog as jax_dog
from sift_tpu.kernels.gaussian import gaussian_blur as jax_blur
from sift_tpu.kernels.gradients import gradient_magnitude_orientation as jax_grad
from sift_tpu.kernels.histogram import parabola_vertex as jax_parabola
from sift_tpu.kernels.histogram import weighted_histogram as jax_hist

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.frontend import parity
from sift_tpu_torch.frontend.extrema import detect_extrema_octave
from sift_tpu_torch.frontend.orientation import (assign_orientation_parity,
                                                 nearest_gaussian_index)
from sift_tpu_torch.frontend.pyramid import build_pyramid, parity_sigma_schedule
from sift_tpu_torch.frontend.refine import refine_octave_parity
from sift_tpu_torch.kernels import resize
from sift_tpu_torch.kernels.derivatives import scale_space_gradient_hessian
from sift_tpu_torch.kernels.dog import dog
from sift_tpu_torch.kernels.gaussian import gaussian_blur
from sift_tpu_torch.kernels.gradients import gradient_magnitude_orientation
from sift_tpu_torch.kernels.histogram import parabola_vertex, weighted_histogram
from tests.torch_dist_world import one_torch_thread  # noqa: F401

T = torch.from_numpy


def _frame(seed, H=56, W=68):
    rng = np.random.default_rng(seed)
    img = ndi.uniform_filter(rng.uniform(0, 255, (H, W)), 3)
    return ((img - img.min()) / (img.max() - img.min()) * 255.0
            ).astype(np.float32)


def _close(got, want, rel=1e-5):
    """Within `rel` of the largest magnitude of `want`."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("h,w,oh,ow", [(7, 9, 4, 5), (8, 10, 4, 5),
                                       (7, 9, 14, 18), (1, 5, 2, 10),
                                       (30, 31, 60, 62), (5, 5, 1, 1)])
def test_resize_nearest_bit_equal(h, w, oh, ow):
    img = _frame(0, h, w)
    np.testing.assert_array_equal(resize._nearest_indices(h, oh),
                                  jax_resize._nearest_indices(h, oh))
    np.testing.assert_array_equal(
        resize.resize_nearest(T(img), oh, ow).numpy(),
        np.asarray(jax_resize.resize_nearest(jnp.asarray(img), oh, ow)))
    if (oh, ow) == ((h + 1) // 2, (w + 1) // 2):
        np.testing.assert_array_equal(
            resize.downsample_half(T(img)).numpy(),
            np.asarray(jax_resize.downsample_half(jnp.asarray(img))))
    if (oh, ow) == (2 * h, 2 * w):
        np.testing.assert_array_equal(
            resize.upsample_double(T(img)).numpy(),
            np.asarray(jax_resize.upsample_double(jnp.asarray(img))))


@pytest.mark.parametrize("shape,out", [((2, 7, 9), (14, 18)),
                                       ((1, 8, 12), (16, 24)),
                                       ((1, 20, 30), (9, 13))])
def test_resize_bilinear_matches_jax(shape, out):
    """2x on odd and even sizes (edges renormalised) and a downscale
    (the kernel widened)."""
    img = np.stack([_frame(s, *shape[1:]) for s in range(shape[0])])
    got = resize.resize_bilinear(T(img), *out).numpy()
    want = np.asarray(jax_resize.resize_bilinear(jnp.asarray(img), *out))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("parity", [True, False])
def test_gradients_match_jax(parity):
    g = np.stack([_frame(1), _frame(2)])
    g[0, 10:14, 10:14] = 77.0          # flat patch: atan2(0, 0)
    mag, ori = gradient_magnitude_orientation(T(g), parity=parity)
    jmag, jori = jax_grad(jnp.asarray(g), parity=parity)
    np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(ori.numpy(), np.asarray(jori), rtol=0,
                               atol=1e-4)
    assert (mag[:, 0] == 0).all() and (ori[:, :, -1] == 0).all()
    if parity:
        o = ori.numpy()          # radians wrapped as degrees (f32)
        assert ((o <= np.pi + 1e-3) | (o >= 360.0 - np.pi - 1e-3)).all()


def test_dog_offset():
    a, b = _frame(3), _frame(4)
    for offset in (True, False):
        np.testing.assert_array_equal(
            dog(T(a), T(b), parity_offset=offset).numpy(),
            np.asarray(jax_dog(jnp.asarray(a), jnp.asarray(b),
                               parity_offset=offset)))


@pytest.mark.parametrize("parity", [True, False])
def test_scale_space_derivatives_bit_equal(parity):
    p = np.random.default_rng(5).uniform(100, 160, (64, 3, 3, 3)
                                         ).astype(np.float32)
    g, h = scale_space_gradient_hessian(T(p), parity=parity)
    jg, jh = jax_sgh(jnp.asarray(p), parity=parity)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))


@pytest.mark.parametrize("nbins,width", [(8, 45.0), (36, 10.0)])
@pytest.mark.parametrize("fold", [True, False])
def test_weighted_histogram_with_nan(nbins, width, fold):
    rng = np.random.default_rng(6)
    vals = rng.uniform(0, 360, (9, 16)).astype(np.float32)
    vals[0, :4] = [np.nan, np.inf, -np.inf, 359.999]
    vals[1] = np.nan                   # a mutated parity window
    vals[2, :3] = [315.0, 350.0, 3.1]  # the folded last bin
    wts = rng.uniform(0, 2, (9, 16)).astype(np.float32)
    got = weighted_histogram(T(vals), T(wts), nbins, width, parity_fold=fold)
    want = jax_hist(jnp.asarray(vals), jnp.asarray(wts), nbins, width,
                    parity_fold=fold)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    if fold:
        assert (got[:, -1] == 0).all()
        np.testing.assert_allclose(got[1, 0].item(), wts[1].sum(), rtol=1e-6)


def test_parabola_vertex_parity_is_nan():
    x = torch.tensor([5.0, 15.0, 355.0])
    y = torch.tensor([1.0, 3.0, 2.0])
    v = parabola_vertex(x - 10, y, x, y + 1, x + 10, y, parity=True)
    jv = jax_parabola(jnp.asarray(x - 10), jnp.asarray(y), jnp.asarray(x),
                      jnp.asarray(y + 1), jnp.asarray(x + 10),
                      jnp.asarray(y), parity=True)
    assert torch.isnan(v).all() and np.isnan(np.asarray(jv)).all()
    assert v.dtype == torch.float32


@pytest.mark.parametrize("n", list(range(3, 16)))
def test_mirror_blur_small_sizes(n):
    """Radius >= size reflects repeatedly: parity's top octaves."""
    img = np.random.default_rng(n).uniform(0, 255, (2, n, n + 1)
                                           ).astype(np.float32)
    for sigma in (1.6, 4.5, 12.8):
        _close(gaussian_blur(T(img), sigma).numpy(),
               jax_blur(jnp.asarray(img), sigma))


@pytest.mark.parametrize("kw", [{}, {"dogs_per_epoch": 5, "octaves": 3,
                                     "sigma": 1.2, "k": 1.3}])
def test_parity_sigma_schedule_bit_equal(kw):
    for a, b in zip(parity_sigma_schedule(SiftConfig(mode="parity", **kw)),
                    jax_schedule(JaxSiftConfig(mode="parity", **kw))):
        np.testing.assert_array_equal(a, b)


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_stacks(img, jcfg):
    pyr = jax_build_pyramid(img, jcfg)
    return pyr.gauss, pyr.dogs


@pytest.mark.parametrize("kw", [dict(mode="parity"),
                                dict(mode="parity", subpixel=True),
                                dict(mode="parity", dogs_per_epoch=4,
                                     octaves=5),
                                dict(mode="lowe", subpixel=True)])
def test_pyramid_matches_jax(kw):
    img = _frame(7, 45, 52)
    pyr = build_pyramid(T(img)[None], SiftConfig(**kw))
    gauss, dogs = _jax_stacks(jnp.asarray(img), JaxSiftConfig(**kw))
    assert pyr.num_octaves == len(gauss)
    for o in range(len(gauss)):
        for ours, theirs in ((pyr.gauss[o][0], gauss[o]),
                             (pyr.dogs[o][0], dogs[o])):
            assert tuple(ours.shape) == theirs.shape
            _close(ours.numpy(), theirs)


# ---- detection onwards, fed JAX's own intermediate products ----

CFG_KW = dict(mode="parity", max_keypoints_per_octave=384,
              max_keypoints=1024)


_jax_detect = jax.jit(jax_detect, static_argnums=(1,))


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_parts(img, jcfg):
    """JAX's `extract_parity`, stage by stage (its body, with each
    product returned)."""
    pyr = jax_build_pyramid(img, jcfg)
    R = jax_ori.R
    dets, refined = [], []
    for o in range(pyr.num_octaves):
        x, y, lvl, score, valid, _ = jax_detect(pyr.dogs[o], jcfg)
        cand = dict(x=x, y=y, level=lvl, score=score, valid=valid,
                    octave=jnp.full_like(lvl, o),
                    scale=jnp.asarray(pyr.dog_sigmas[o], jnp.float32)[lvl])
        dets.append(cand)
        refined.append(jax_refine(pyr.dogs[o], cand, jcfg))
    kp = {k: jnp.concatenate([b[k] for b in refined]) for k in refined[0]}
    kp = jax_parity._canonical_sort(kp)
    kp = {k: v[:jcfg.max_keypoints] for k, v in kp.items()}
    h0, w0 = pyr.gauss[0].shape[-2:]
    shapes = np.array([g.shape[-2:] for g in pyr.gauss])
    mags, oris, gs, wtls = [], [], [], []
    for g in pyr.gauss:
        m, th = jax_grad(g, parity=True)
        mags.append(jax_parity._pad_to(m, h0, w0))
        oris.append(jax_parity._pad_to(th, h0, w0))
        gs.append(jax_parity._pad_to(g, h0, w0))
        wtls.append(jax_parity._pad_to(
            jax_blur(g, 1.6)[..., :2 * R, :2 * R], 2 * R, 2 * R))
    stacks = [jnp.stack(a) for a in (mags, oris, gs, wtls)]
    kp = jax_ori.assign_orientation_parity(kp, *stacks[:3], pyr.gauss_sigmas,
                                           shapes, jcfg)
    desc, ok = jax_parity.descriptor_scan_parity(kp, *stacks, shapes, jcfg)
    return pyr.dogs, dets, refined, kp, stacks, desc, ok


@pytest.fixture(scope="module", params=[False, True], ids=["sub0", "sub1"])
def parts(request):
    cfg = SiftConfig(subpixel=request.param, **CFG_KW)
    jcfg = JaxSiftConfig(subpixel=request.param, **CFG_KW)
    img = _frame(8, 48, 60)
    out = jax.tree.map(lambda a: np.array(a),
                       _jax_parts(jnp.asarray(img), jcfg))
    shapes = np.array([d.shape[-2:] for d in out[0]])
    return cfg, jcfg, shapes, out


def test_parity_extrema_bit_equal(parts):
    """On the materialized DoG stacks: inside one jitted pyramid XLA
    computes |DoG - 128| from the unrounded difference, half an ulp of 128
    from this."""
    cfg, jcfg, _, (dogs, *_rest) = parts
    n = 0
    for o, d in enumerate(dogs):
        want = _jax_detect(jnp.asarray(d), jcfg)
        got = detect_extrema_octave(T(d)[None], cfg, o)
        for f, a, b in zip(("x", "y", "level", "score", "valid", "n_drop"),
                           got, want):
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b),
                                          err_msg=f)
        n += int(np.asarray(want[4]).sum())
    assert n > 50


def test_refine_parity_valid_equal(parts):
    cfg, _, _, (dogs, dets, refined, *_rest) = parts
    kept = 0
    for d, cand, want in zip(dogs, dets, refined):
        got = refine_octave_parity(
            T(d)[None], {k: T(v)[None] for k, v in cand.items()}, cfg)
        np.testing.assert_array_equal(got["valid"][0].numpy(), want["valid"])
        np.testing.assert_array_equal(got["x"][0].numpy(), want["x"])
        kept += int(want["valid"].sum())
    assert 0 < kept < sum(int(c["valid"].sum()) for c in dets)


def _tensors(d):
    return {k: T(np.ascontiguousarray(v)) for k, v in d.items()}


def test_canonical_sort_matches_lexsort(parts):
    *_, (_, _, refined, _, _, _, _) = parts
    kp = {k: np.concatenate([b[k] for b in refined]) for k in refined[0]}
    got = parity._canonical_sort(_tensors(kp))
    want = jax_parity._canonical_sort({k: jnp.asarray(v) for k, v in kp.items()})
    for k in kp:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_canonical_sort_ties():
    """Equal keys (padding at x = y = 0, repeated positions) keep their
    input order, as `jnp.lexsort` (stable) keeps them."""
    rng = np.random.default_rng(9)
    n = 400
    kp = dict(x=rng.integers(0, 4, n).astype(np.float32),
              y=rng.integers(0, 3, n).astype(np.float32),
              level=rng.integers(1, 3, n).astype(np.int32),
              octave=rng.integers(0, 2, n).astype(np.int32),
              valid=rng.uniform(size=n) < 0.6,
              tag=np.arange(n, dtype=np.int32))
    got = parity._canonical_sort(_tensors(kp))
    want = jax_parity._canonical_sort({k: jnp.asarray(v) for k, v in kp.items()})
    np.testing.assert_array_equal(got["tag"].numpy(), np.asarray(want["tag"]))


def test_assign_orientation_parity(parts):
    _, jcfg, shapes, (_, _, _, jkp, *_rest) = parts
    gs, _ = jax_schedule(jcfg)
    pre = {k: T(np.ascontiguousarray(v)) for k, v in jkp.items()
           if k not in ("gauss_o", "gauss_l")}
    got = assign_orientation_parity(pre, gs, shapes)
    for f in ("gauss_o", "gauss_l", "valid"):
        np.testing.assert_array_equal(got[f].numpy(), jkp[f], err_msg=f)
    assert torch.isnan(got["orientation"]).all()
    jo, jl = jax_ori.nearest_gaussian_index(jnp.asarray(jkp["scale"] * 80.0),
                                            gs)
    o, l = nearest_gaussian_index(T(jkp["scale"] * 80.0), gs)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))


def test_descriptor_scan_on_jax_inputs(parts):
    *_, (_, _, _, jkp, stacks, jdesc, jok) = parts
    mag, ori, gauss, wtl = (T(np.ascontiguousarray(a)) for a in stacks)
    # the port's scan takes a batch: this image as a batch of one
    desc, ok = parity.descriptor_scan_parity(
        {k: v[None] for k, v in _tensors(jkp).items()},
        torch.stack([mag, ori], dim=2)[None], gauss[None], wtl[None],
        parts[2])
    desc, ok = desc[0], ok[0]
    np.testing.assert_array_equal(ok.numpy(), jok)
    assert jok.sum() > 10
    np.testing.assert_allclose(desc.numpy()[jok], jdesc[jok], rtol=0,
                               atol=1e-5)
    assert (desc.numpy()[~jok] == 0).all()
