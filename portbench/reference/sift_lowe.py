"""Plain PyTorch reference of the lowe SIFT frontend.

A frozen copy of what the extraction computes: with `subpixel`, a
bilinear 2x input (half-pixel centres, edge weights renormalised) taken
as blurred by 1.0; the incremental Gaussian
pyramid as a mirror-bordered shifted-add stencil, the strict 26-neighbour
extrema with the contrast pre-threshold and the per-octave caps, the five
step Taylor walk on 16x16 DoG patches, the contrast and edge tests, the
36-bin orientation histogram on bfloat16 gradient windows, the 4x4x8
descriptors of both orientation peaks (L2-normalised, clamped and
renormalised, or with `rootsift` L1-normalised and square-rooted), and
the global top-K by score.
Every stage is written out here in plain tensor operations; nothing is
imported from the program under test.

`Precision` says how the reference computes: `EXACT` is the stated
precision (float32 throughout, full-precision products); `CONTROL`
stores every pyramid level and DoG in bfloat16, takes the descriptor's
and the distances' products on TF32-rounded operands and fits in
float32; `CONTROL_TF32` lowers only the products stated as float32 with
TF32 off to TF32, so its keypoints are the exact ones and what departs
is the descriptors and distances.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Precision:
    pyramid: torch.dtype = torch.float32   # storage of levels and DoGs
    tf32_products: bool = False            # round product operands to TF32
    fit: torch.dtype = torch.float64       # homography fits


EXACT = Precision()
CONTROL = Precision(pyramid=torch.bfloat16, tf32_products=True,
                    fit=torch.float32)
CONTROL_TF32 = Precision(tf32_products=True)
CONTROLS = {"control": CONTROL, "control_tf32": CONTROL_TF32}

R_DESC = 24          # 48x48 gradient windows
R_ORI = 8            # the orientation histogram's central 16x16
PATCH = 16           # the refine walk's patch side
WALK_STEPS = 5
MAX_PEAKS = 2
DESC_CHUNK = 512     # keypoints a descriptor pass
FIELDS = ("x", "y", "octave", "level", "scale", "score", "orientation",
          "valid")

_NUMPY = {torch.exp: np.exp, torch.atan2: np.arctan2, torch.sin: np.sin,
          torch.cos: np.cos, torch.pow: np.power}


def lanewise(fn, *xs):
    """`fn(*xs)`; on the CPU through NumPy, whose loops round every element
    alike wherever it sits in the tensor."""
    if xs[0].is_cuda:
        return fn(*xs)
    args = [np.ascontiguousarray(x.detach().numpy()) for x in xs]
    return torch.from_numpy(np.ascontiguousarray(_NUMPY[fn](*args)))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10-bit mantissa (nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _store(x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return x if prec.pyramid == torch.float32 else \
        x.to(prec.pyramid).to(torch.float32)


# ---------------------------------------------------------------- pyramid

def gaussian_taps(sigma: float) -> np.ndarray:
    r = max(1, int(3.0 * float(sigma) + 0.5))
    x = np.arange(-r, r + 1, dtype=np.float64)
    taps = np.exp(-0.5 * (x / float(sigma)) ** 2)
    return (taps / taps.sum()).astype(np.float32)


def incremental_sigma(s0: float, s1: float) -> float:
    return math.sqrt(s1 * s1 - s0 * s0)


def _mirror(n: int, r: int, device) -> torch.Tensor:
    j = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(j)
    period = 2 * n - 2
    j = torch.remainder(j, period)
    return torch.where(j < n, j, period - j)


def _stencil(img: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    n = img.shape[dim]
    r = (len(taps) - 1) // 2
    padded = img.index_select(dim, _mirror(n, r, img.device))
    out = None
    for k, t in enumerate(taps.tolist()):
        term = padded.narrow(dim, k, n) * t
        out = term if out is None else out + term
    return out


def blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable mirror-bordered Gaussian: along W, then along H, one
    product and one add a tap, in tap order."""
    taps = gaussian_taps(sigma)
    return _stencil(_stencil(img, taps, img.dim() - 1), taps, img.dim() - 2)


def sigma_tables(cfg):
    o, d = cfg["octaves"], cfg["dogs_per_epoch"]
    within = np.array([cfg["sigma"] * cfg["k"] ** j for j in range(d + 1)])
    gs = np.tile(within, (o, 1))
    ds = np.sqrt(gs[:, :-1] * gs[:, 1:])
    return gs, ds


def _double(img: torch.Tensor, dim: int) -> torch.Tensor:
    """Bilinear 2x along `dim` with half-pixel centres: output 2m reads
    sources m-1 and m at 1/4 and 3/4, output 2m+1 sources m and m+1 at 3/4
    and 1/4; a source past the edge drops out and the other weighs 1."""
    n = img.shape[dim]
    dev = img.device
    m = torch.arange(n, device=dev)
    lo = torch.stack([m - 1, m], 1).reshape(-1)       # first source
    hi = torch.stack([m, m + 1], 1).reshape(-1)       # second source
    w_lo = torch.tensor([0.25, 0.75], device=dev).repeat(n)
    w_hi = 1.0 - w_lo
    w_lo = torch.where(lo < 0, 0.0, torch.where(hi >= n, 1.0, w_lo))
    w_hi = torch.where(hi >= n, 0.0, torch.where(lo < 0, 1.0, w_hi))
    shape = [1] * img.dim()
    shape[dim] = 2 * n
    a = img.index_select(dim, lo.clamp(0, n - 1)) * w_lo.reshape(shape)
    b = img.index_select(dim, hi.clamp(0, n - 1)) * w_hi.reshape(shape)
    return a + b


def upsample2(img: torch.Tensor) -> torch.Tensor:
    """(..., 2H, 2W) bilinear doubling, along W, then along H."""
    return _double(_double(img, img.dim() - 1), img.dim() - 2)


def pyramid(img: torch.Tensor, cfg, prec: Precision):
    """(gauss, dogs): per octave (B, d+1, H, W) and (B, d, H, W)."""
    d = cfg["dogs_per_epoch"]
    gs, _ = sigma_tables(cfg)
    sigma_n = 0.5
    if cfg.get("subpixel"):
        img, sigma_n = upsample2(img), 1.0
    base = _store(img, prec)
    if cfg["sigma"] > sigma_n:
        base = _store(blur(base, incremental_sigma(sigma_n, cfg["sigma"])),
                      prec)
    gauss, dogs = [], []
    for i in range(cfg["octaves"]):
        levels = [base]
        for j in range(1, d + 1):
            levels.append(_store(blur(levels[-1], incremental_sigma(
                float(gs[i, j - 1]), float(gs[i, j]))), prec))
        gauss.append(torch.stack(levels, dim=-3))
        dogs.append(_store(torch.stack([levels[j] - levels[j - 1]
                                        for j in range(1, d + 1)], dim=-3),
                           prec))
        if i < cfg["octaves"] - 1:
            base = levels[d - 1][..., ::2, ::2].contiguous()
    return gauss, dogs


# ---------------------------------------------------------------- extrema

def top_k_stable(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _window_extreme(x: torch.Tensor, is_max: bool) -> torch.Tensor:
    op = torch.maximum if is_max else torch.minimum
    xp = F.pad(x, (1, 1, 1, 1), value=float("-inf") if is_max else float("inf"))
    h, w = x.shape[-2:]
    out = None
    for dy in range(3):
        for dx in range(3):
            s = xp[..., dy:dy + h, dx:dx + w]
            out = s if out is None else op(out, s)
    return out


def extrema(dogs: torch.Tensor, cfg, octave: int):
    """(x, y, level, score, valid), each (B, K), K the octave's cap."""
    B, L, H, W = dogs.shape
    K = max(cfg["max_keypoints_per_octave"] >> octave, 64)
    wmax = _window_extreme(dogs, True)
    wmin = _window_extreme(dogs, False)
    interior = torch.zeros((H, W), dtype=torch.bool, device=dogs.device)
    interior[1:-1, 1:-1] = True
    thresh = 0.5 * cfg["contrast_threshold"] * cfg["image_max"] / max(L - 2, 1)
    masks, scores = [], []
    for i in range(1, L - 1):
        c = dogs[:, i]
        is_max = ((wmax[:, i] <= c) & (wmax[:, i - 1] < c)
                  & (wmax[:, i + 1] < c) & (c > thresh))
        is_min = ((wmin[:, i] >= c) & (wmin[:, i - 1] > c)
                  & (wmin[:, i + 1] > c) & (c < -thresh))
        masks.append((is_max | is_min) & interior)
        scores.append(c.abs())
    mask = torch.stack(masks, dim=1)
    flat = torch.where(mask, torch.stack(scores, dim=1), -1.0).reshape(B, -1)
    k_eff = min(K, flat.shape[1])
    top, idx = top_k_stable(flat, k_eff)
    if k_eff < K:
        top = F.pad(top, (0, K - k_eff), value=-1.0)
        idx = F.pad(idx, (0, K - k_eff))
    lvl = idx // (H * W) + 1
    rem = idx % (H * W)
    return ((rem % W).to(torch.float32), (rem // W).to(torch.float32),
            lvl.to(torch.int32), top, top >= 0.0)


# ------------------------------------------------------------- refinement

def grad_hess(p: torch.Tensor):
    """Central-difference gradient and Hessian of (..., 3, 3, 3) cubes
    [s, y, x]; component order (x, y, s)."""
    c = p[..., 1, 1, 1]
    dx = (p[..., 1, 1, 2] - p[..., 1, 1, 0]) / 2.0
    dy = (p[..., 1, 2, 1] - p[..., 1, 0, 1]) / 2.0
    ds = (p[..., 2, 1, 1] - p[..., 0, 1, 1]) / 2.0
    dxx = p[..., 1, 1, 2] + p[..., 1, 1, 0] - 2.0 * c
    dyy = p[..., 1, 2, 1] + p[..., 1, 0, 1] - 2.0 * c
    dss = p[..., 2, 1, 1] + p[..., 0, 1, 1] - 2.0 * c
    dxy = (p[..., 1, 2, 2] - p[..., 1, 2, 0] - p[..., 1, 0, 2] + p[..., 1, 0, 0]) / 4.0
    dxs = (p[..., 2, 1, 2] - p[..., 2, 1, 0] - p[..., 0, 1, 2] + p[..., 0, 1, 0]) / 4.0
    dys = (p[..., 2, 2, 1] - p[..., 2, 0, 1] - p[..., 0, 2, 1] + p[..., 0, 0, 1]) / 4.0
    hess = torch.stack([torch.stack([dxx, dxy, dxs], -1),
                        torch.stack([dxy, dyy, dys], -1),
                        torch.stack([dxs, dys, dss], -1)], -2)
    return torch.stack([dx, dy, ds], -1), hess


def solve3x3(h: torch.Tensor, g: torch.Tensor, eps: float = 1e-12):
    """Adjugate solve of h x = g, products summed left to right."""
    det = (h[..., 0, 0] * (h[..., 1, 1] * h[..., 2, 2] - h[..., 1, 2] * h[..., 2, 1])
           - h[..., 0, 1] * (h[..., 1, 0] * h[..., 2, 2] - h[..., 1, 2] * h[..., 2, 0])
           + h[..., 0, 2] * (h[..., 1, 0] * h[..., 2, 1] - h[..., 1, 1] * h[..., 2, 0]))
    adj = [
        [h[..., 1, 1] * h[..., 2, 2] - h[..., 1, 2] * h[..., 2, 1],
         h[..., 0, 2] * h[..., 2, 1] - h[..., 0, 1] * h[..., 2, 2],
         h[..., 0, 1] * h[..., 1, 2] - h[..., 0, 2] * h[..., 1, 1]],
        [h[..., 1, 2] * h[..., 2, 0] - h[..., 1, 0] * h[..., 2, 2],
         h[..., 0, 0] * h[..., 2, 2] - h[..., 0, 2] * h[..., 2, 0],
         h[..., 0, 2] * h[..., 1, 0] - h[..., 0, 0] * h[..., 1, 2]],
        [h[..., 1, 0] * h[..., 2, 1] - h[..., 1, 1] * h[..., 2, 0],
         h[..., 0, 1] * h[..., 2, 0] - h[..., 0, 0] * h[..., 2, 1],
         h[..., 0, 0] * h[..., 1, 1] - h[..., 0, 1] * h[..., 1, 0]],
    ]
    ok = det.abs() > eps
    safe = torch.where(ok, det, torch.ones_like(det))
    x = torch.stack([(a[0] * g[..., 0] + a[1] * g[..., 1] + a[2] * g[..., 2])
                     / safe for a in adj], dim=-1)
    return x, ok


def refine_walk(dogs, x, y, level):
    """Five Taylor steps per candidate on its (L, 16, 16) DoG patch, cut
    at clamp(position - 8, 0, size - 16); taps read by the patch's flat
    cell (a column step past the patch wraps a row), cells past the
    patch or the image read 0. Returns the final cube (B, K, 27) and the
    final (x, y, level, converged) (B, K, 4)."""
    B, L, H, W = dogs.shape
    K = x.shape[1]
    D = PATCH
    xi = x.reshape(-1).to(torch.int32)
    yi = y.reshape(-1).to(torch.int32)
    x0 = torch.clamp(xi - D // 2, 0, max(W - D, 0))
    y0 = torch.clamp(yi - D // 2, 0, max(H - D, 0))
    Hp, Wp = H + D, W + D
    flat = F.pad(dogs, (0, D, 0, D)).reshape(-1)
    img = torch.arange(B, device=dogs.device).repeat_interleave(K)
    base = ((img * L) * Hp + y0.long()) * Wp + x0.long()
    t = torch.arange(-1, 2, device=dogs.device)

    def lookup(li, ly, lx):
        s = (li[:, None] + t)[:, :, None, None]
        cell = ((ly[:, None] + t)[:, None, :, None] * D
                + (lx[:, None] + t)[:, None, None, :])
        inside = ((cell >= 0) & (cell < D * D)).expand(li.shape[0], 3, 3, 3)
        cell = torch.where(inside[:, :1], cell, 0)
        idx = (base[:, None, None, None] + s.long() * (Hp * Wp)
               + (cell // D) * Wp + cell % D)
        vals = flat[idx.reshape(B * K, 27)]
        return torch.where(inside.reshape(B * K, 27), vals,
                           torch.zeros_like(vals))

    lx, ly, li = xi - x0, yi - y0, level.reshape(-1)
    lxmin, lxmax, lymin, lymax = 1 - x0, (W - 2) - x0, 1 - y0, (H - 2) - y0
    converged = torch.zeros(B * K, dtype=torch.bool, device=dogs.device)
    for _ in range(WALK_STEPS):
        grad, hess = grad_hess(lookup(li, ly, lx).reshape(-1, 3, 3, 3))
        off, solvable = solve3x3(hess, -grad)
        off = torch.where(solvable[:, None], off, torch.zeros_like(off))
        small = (off.abs() < 0.5).all(dim=-1)
        move = ~converged & ~small
        step = torch.where(move[:, None],
                           torch.round(off).clamp(-1, 1).to(torch.int32), 0)
        lx = torch.clamp(lx + step[:, 0], lxmin, lxmax)
        ly = torch.clamp(ly + step[:, 1], lymin, lymax)
        li = torch.clamp(li + step[:, 2], 1, L - 2)
        converged = converged | small
    cube = lookup(li, ly, lx)
    walk = torch.stack([x0 + lx, y0 + ly, li, converged.to(torch.int32)],
                       dim=1).to(torch.int32)
    return cube.reshape(B, K, 27), walk.reshape(B, K, 4)


def refine(dogs, cand, cfg, dog_sigmas, octave, octave_factor):
    cube, walk = refine_walk(dogs, cand["x"], cand["y"], cand["level"])
    xi, yi, li = walk[..., 0], walk[..., 1], walk[..., 2]
    grad, hess = grad_hess(cube.unflatten(-1, (3, 3, 3)))
    off, solvable = solve3x3(hess, -grad)
    d_hat = cube[..., 13] + 0.5 * (grad * off).sum(dim=-1)
    contrast_ok = d_hat.abs() >= cfg["contrast_threshold"] * cfg["image_max"]
    dxx, dyy, dxy = hess[..., 0, 0], hess[..., 1, 1], hess[..., 0, 1]
    tr, det = dxx + dyy, dxx * dyy - dxy * dxy
    r = cfg["edge_r"]
    edge_ok = (det > 0) & (tr * tr / torch.where(det > 0, det, torch.ones_like(det))
                           < (r + 1) ** 2 / r)
    in_range = (off.abs() < 0.6).all(dim=-1) & (walk[..., 3] > 0) & solvable
    dev = dogs.device
    table = torch.tensor(dog_sigmas[octave], dtype=torch.float32, device=dev)
    scale = (table[li.long()]
             * lanewise(torch.pow, torch.tensor(cfg["k"], dtype=torch.float32,
                                                device=dev), off[..., 2])
             * torch.tensor(octave_factor ** octave, dtype=torch.float32,
                            device=dev))
    out = dict(cand)
    out.update(x=xi.to(torch.float32) + off[..., 0],
               y=yi.to(torch.float32) + off[..., 1], level=li, scale=scale,
               valid=cand["valid"] & contrast_ok & edge_ok & in_range)
    return out


# ------------------------------------------------ orientation, descriptor

def gradient_xy(g: torch.Tensor):
    dx = torch.zeros_like(g)
    dy = torch.zeros_like(g)
    dx[..., 1:-1] = (g[..., 2:] - g[..., :-2]) * 0.5
    dy[..., 1:-1, :] = (g[..., 2:, :] - g[..., :-2, :]) * 0.5
    return dx, dy


def gradient_windows(dxm, dym, gl, y, x, radius, window_dtype):
    """(K, 2, 2r, 2r) f32 windows of the (L, H, W) gradient maps, stored
    in `window_dtype` first; pixels past the bottom or right read 0."""
    L, H, W = dxm.shape
    d = 2 * radius
    maps = torch.stack([dxm, dym])
    if window_dtype == "bfloat16" and d % 16 == 0:
        maps = maps.to(torch.bfloat16)
    yi = torch.clamp(y.to(torch.int32), radius, max(H - radius, radius))
    xi = torch.clamp(x.to(torch.int32), radius, max(W - radius, radius))
    mp = F.pad(maps, (0, d, 0, d))
    ar = torch.arange(d, device=maps.device)
    yy = ((yi - radius).long()[:, None] + ar)[:, :, None]
    xx = ((xi - radius).long()[:, None] + ar)[:, None, :]
    win = mp[:, gl.long()[:, None, None], yy, xx]
    wins = win.permute(1, 0, 2, 3).to(torch.float32).contiguous()
    return wins, yi.to(torch.float32) - radius - y, \
        xi.to(torch.float32) - radius - x


def _smooth(hist: torch.Tensor, passes: int = 2) -> torch.Tensor:
    for _ in range(passes):
        hm2, hm1 = torch.roll(hist, 2, -1), torch.roll(hist, 1, -1)
        hp1, hp2 = torch.roll(hist, -1, -1), torch.roll(hist, -2, -1)
        hist = (hm2 + hp2 + 4.0 * (hm1 + hp1) + 6.0 * hist) / 16.0
    return hist


def _parabola(xl, yl, xp, yp, xr, yr):
    denom = (xl - xp) * (xl - xr) * (xp - xr)
    a = (xr * (yp - yl) + xp * (yl - yr) + xl * (yr - yp)) / denom
    b = (xr * xr * (yl - yp) + xp * xp * (yr - yl) + xl * xl * (yp - yr)) / denom
    safe = a.abs() > 1e-12
    return torch.where(safe, -b / (2.0 * torch.where(safe, a, torch.ones_like(a))),
                       xp)


def orientations(gx, gy, oy0, ox0, sigma_within, in_bounds, cfg):
    """36-bin histogram over the central 16x16, smoothed twice, and its
    two highest peaks at or over `ori_peak_rel` of the maximum."""
    K, d, _ = gx.shape
    c0, c1 = d // 2 - R_ORI, d // 2 + R_ORI
    sgx = gx[:, c0:c1, c0:c1].reshape(K, -1)
    sgy = gy[:, c0:c1, c0:c1].reshape(K, -1)
    mag = torch.sqrt(sgx * sgx + sgy * sgy)
    ang = torch.remainder(torch.rad2deg(lanewise(torch.atan2, sgy, sgx))
                          + 360.0, 360.0)
    rows = torch.arange(2 * R_ORI, dtype=torch.float32, device=gx.device) + c0
    oy = oy0[:, None, None] + rows[None, :, None]
    ox = ox0[:, None, None] + rows[None, None, :]
    sw = 1.5 * sigma_within
    wgt = lanewise(torch.exp, -(ox * ox + oy * oy).reshape(K, -1)
                   / (2.0 * sw * sw)[:, None])
    bins = torch.clamp((ang / 10.0).to(torch.int64), 0, 35)
    votes = mag * wgt
    hist = torch.zeros((K, 36), dtype=torch.float32, device=gx.device)
    step = K if gx.is_cuda else max(1, 16384 // votes.shape[1])
    for i in range(0, K, step):
        part = hist[i:i + step]
        rk = torch.arange(part.shape[0], device=gx.device)[:, None]
        part.index_put_((rk.expand(-1, votes.shape[1]), bins[i:i + step]),
                        votes[i:i + step], accumulate=True)
    hist = _smooth(hist)
    hist = torch.where(in_bounds[:, None], hist, torch.zeros_like(hist))
    left, right = torch.roll(hist, 1, -1), torch.roll(hist, -1, -1)
    hmax = hist.max(dim=-1, keepdim=True).values
    is_peak = ((hist >= left) & (hist > right)
               & (hist >= cfg["ori_peak_rel"] * hmax) & (hmax > 0))
    top, idx = top_k_stable(torch.where(is_peak, hist, float("-inf")),
                            MAX_PEAKS)
    centers = idx.to(torch.float32) * 10.0 + 5.0
    v = _parabola(centers - 10.0, torch.gather(left, -1, idx), centers,
                  torch.gather(hist, -1, idx), centers + 10.0,
                  torch.gather(right, -1, idx))
    return torch.remainder(v, 360.0), torch.isfinite(top)


def _descriptor_chunk(wins, scal, prec: Precision):
    K, _, d, _ = wins.shape
    P = d * d
    dev = wins.device
    gx, gy = wins[:, 0].reshape(K, P), wins[:, 1].reshape(K, P)
    mag = torch.sqrt(gx * gx + gy * gy)
    a45 = torch.rad2deg(lanewise(torch.atan2, gy, gx)) * (1.0 / 45.0)
    pidx = torch.arange(P, device=dev)
    oy = scal[:, 0:1] + (pidx // d).to(torch.float32)
    ox = scal[:, 1:2] + (pidx % d).to(torch.float32)
    inv_hw = scal[:, 2:3]
    cc = torch.tensor([-1.5, -0.5, 0.5, 1.5], device=dev)
    out = []
    for pk in range(MAX_PEAKS):
        cos_t, sin_t, ori45 = (scal[:, 3 + 3 * pk + j:4 + 3 * pk + j]
                               for j in range(3))
        u = (ox * cos_t + oy * sin_t) * inv_hw
        v = (oy * cos_t - ox * sin_t) * inv_hw
        w = mag * lanewise(torch.exp, (u * u + v * v) * -0.125)
        dd = a45 - ori45
        ob = dd - 8.0 * torch.floor(dd * 0.125) - 0.5
        b0f = torch.floor(ob)
        frac = ob - b0f
        b0 = torch.where(b0f < 0.0, b0f + 8.0, b0f)
        b1 = torch.where(b0 >= 7.0, b0 - 7.0, b0 + 1.0)
        wf = w * frac
        ok = ~torch.isnan(b0)
        q = torch.zeros((K, P, 8), dtype=torch.float32, device=dev)
        q.scatter_(2, torch.where(ok, b0, 0.0).long()[..., None],
                   torch.where(ok, w - wf, 0.0)[..., None])
        q.scatter_(2, torch.where(ok, b1, 0.0).long()[..., None],
                   torch.where(ok, wf, 0.0)[..., None])
        tu = (1.0 - (u[..., None] - cc).abs()).clamp_min(0.0)
        tv = (1.0 - (v[..., None] - cc).abs()).clamp_min(0.0)
        sab = (tv[..., :, None] * tu[..., None, :]).reshape(K, P, 16)
        lhs, rhs = sab.transpose(1, 2), q
        if prec.tf32_products:
            lhs, rhs = tf32(lhs), tf32(rhs)
        out.append(torch.bmm(lhs, rhs).reshape(K, 128))
    return torch.stack(out, dim=1)


def descriptors(wins, oy0, ox0, peak_oris, sigma_within, cfg,
                prec: Precision):
    """(K, 2, 128) normalised descriptors, one a peak."""
    K = wins.shape[0]
    hw = torch.clamp_min(3.0 * sigma_within, 1e-3)
    theta = peak_oris * (math.pi / 180.0)
    cols = [oy0, ox0, 1.0 / hw]
    for pk in range(MAX_PEAKS):
        cols += [lanewise(torch.cos, theta[:, pk]),
                 lanewise(torch.sin, theta[:, pk]),
                 peak_oris[:, pk] * (1.0 / 45.0)]
    scal = torch.stack(cols, dim=1).to(torch.float32)
    chunk = 64 if not wins.is_cuda else DESC_CHUNK
    pad = -K % chunk
    if pad:
        wins = torch.cat([wins, wins.new_zeros((pad,) + wins.shape[1:])])
        scal = torch.cat([scal, scal.new_zeros((pad, scal.shape[1]))])
    raw = torch.cat([_descriptor_chunk(wins[i:i + chunk], scal[i:i + chunk],
                                       prec)
                     for i in range(0, K + pad, chunk)])[:K]
    norm = torch.linalg.vector_norm(raw, dim=-1, keepdim=True)
    desc = (raw / norm.clamp_min(1e-7)).clamp_max(
        cfg["descriptor_max_component"])
    if cfg.get("rootsift"):
        total = desc.sum(dim=-1, keepdim=True)
        return torch.sqrt(desc / total.clamp_min(1e-7))
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    return desc / norm.clamp_min(1e-7)


# ------------------------------------------------------------------ entry

def extract(imgs: torch.Tensor, cfg: dict, prec: Precision = EXACT) -> dict:
    """Keypoints of (B, H, W) float32 images in [0, image_max]: a dict of
    (B, N) tensors `FIELDS` and `desc` (B, N, 128), N = max_keypoints,
    invalid slots last. `cfg` holds the SiftConfig fields of a lowe
    extraction; positions are in level coordinates of the (with
    `subpixel`, doubled) input."""
    if cfg.get("mode", "lowe") != "lowe":
        raise ValueError("the reference covers lowe extraction only")
    with torch.no_grad():
        imgs = imgs.to(torch.float32)
        gauss, dogs = pyramid(imgs, cfg, prec)
        return _extract(imgs, gauss, dogs, cfg, prec)


def _extract(imgs, gauss, dogs, cfg, prec):
    B = imgs.shape[0]
    dev = imgs.device
    gs, ds = sigma_tables(cfg)
    ofac = cfg["k"] ** (cfg["dogs_per_epoch"] - 1)
    parts = {f: [] for f in FIELDS}
    descs = []
    P = MAX_PEAKS
    for o in range(cfg["octaves"]):
        x, y, lvl, score, valid = extrema(dogs[o], cfg, o)
        cand = refine(dogs[o], dict(x=x, y=y, level=lvl, score=score,
                                    valid=valid), cfg, ds, o, ofac)
        g = gauss[o]
        L1, H, W = g.shape[-3:]
        K = cand["x"].shape[1]
        dxm, dym = gradient_xy(g)
        sw = cand["scale"] / torch.tensor(ofac ** o, dtype=torch.float32,
                                          device=dev)
        table = torch.tensor(gs[o], dtype=torch.float32, device=dev)
        gl = torch.argmin((table - sw[..., None]).abs(), dim=-1)
        in_bounds = ((cand["x"] >= R_ORI) & (cand["x"] < W - R_ORI)
                     & (cand["y"] >= R_ORI) & (cand["y"] < H - R_ORI))
        sw_f, ib_f = sw.reshape(B * K), in_bounds.reshape(B * K)
        r_eff = min(R_DESC, H // 2, W // 2)
        if r_eff < R_ORI:
            oris = torch.zeros((B * K, P), dtype=torch.float32, device=dev)
            pvalid = torch.zeros((B * K, P), dtype=torch.bool, device=dev)
            wins = torch.zeros((B * K, 2, 2 * R_ORI, 2 * R_ORI), device=dev)
            oy0 = torch.zeros((B * K,), device=dev)
            ox0 = torch.zeros_like(oy0)
        else:
            gl_f = (gl + torch.arange(B, device=dev)[:, None] * L1).reshape(-1)
            wins, oy0, ox0 = gradient_windows(
                dxm.reshape(B * L1, H, W), dym.reshape(B * L1, H, W), gl_f,
                cand["y"].reshape(-1), cand["x"].reshape(-1), r_eff,
                cfg["window_dtype"])
            oris, pvalid = orientations(wins[:, 0], wins[:, 1], oy0, ox0,
                                        sw_f, ib_f, cfg)

        def rep(a):
            return torch.repeat_interleave(a, P, dim=1)
        parts["x"].append(rep(cand["x"]))
        parts["y"].append(rep(cand["y"]))
        parts["octave"].append(torch.full((B, K * P), o, dtype=torch.int32,
                                          device=dev))
        parts["level"].append(rep(cand["level"]))
        parts["scale"].append(rep(cand["scale"]))
        parts["score"].append(rep(cand["score"]))
        parts["orientation"].append(oris.reshape(B, K * P))
        parts["valid"].append(rep(cand["valid"] & in_bounds)
                              & pvalid.reshape(B, K * P))
        descs.append(descriptors(wins, oy0, ox0, oris, sw_f, cfg,
                                 prec).reshape(B, K * P, -1))
    kp = {f: torch.cat(v, dim=1) for f, v in parts.items()}
    desc = torch.cat(descs, dim=1)
    N = min(cfg["max_keypoints"], kp["score"].shape[1])
    top, idx = top_k_stable(torch.where(kp["valid"], kp["score"],
                                        float("-inf")), N)
    out = {f: torch.gather(kp[f], 1, idx) for f in FIELDS}
    out["valid"] = out["valid"] & torch.isfinite(top)
    out["desc"] = torch.gather(desc, 1, idx[..., None].expand(-1, -1, 128))
    return out
