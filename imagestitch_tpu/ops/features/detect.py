"""Batched keypoint detection.

Batched replacement for the reference's OpenCV detector calls
(reference: ImageUtility.py:248-276 detectAndDescribe; CUDA variants
appendix/myGpuFeatures.cpp:67-146).  Two response families:

  * "hessian" (SIFT/SURF parity) — scale-space blob response over a true
    octave pyramid (mean-pool 2x per octave, ``n_octave_layers`` sigmas per
    octave; reference knobs ImageUtility.py:24-25).  The response is either
    a bank of separable Gaussian-derivative convolutions (determinant of
    Hessian; dense and fused) or, with ``box_filter``, the
    reference detector's actual integral-image SURF box filters
    (Bay et al.; what cv2.xfeatures2d.SURF computes) for closer bit-parity.
  * "corner" (ORB parity) — the true FAST-9 segment test (16-point Bresenham
    circle, contiguous-9 bright/dark arc at ``fast_threshold``;
    ImageUtility.py:38) gating a Harris corner score (ORB's own ranking),
    evaluated over the ORB scale pyramid (``n_levels`` levels spaced by
    ``scale_factor``, border ``edge_threshold``; ImageUtility.py:32-34).

Keypoint positions are sub-pixel (quadratic fit on the 3x3 response
neighborhood), matching OpenCV's float keypoints — the mode vote truncates
keypoint *differences*, so integer-quantized positions would bias the vote.

Fixed-capacity outputs: every image yields exactly ``max_kp`` keypoints
(score-sorted, padded with score<=0) so all downstream shapes are static.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class DetectParams:
    """Static (hashable) detector configuration — see config.FeatureConfig."""
    family: str = "hessian"        # "hessian" | "corner"
    threshold: float = 10.0        # hessian response floor
    n_octaves: int = 4             # ImageUtility.py:24
    n_octave_layers: int = 3       # ImageUtility.py:25
    base_sigma: float = 1.2
    box_filter: bool = False       # integral-image SURF box response
    border: int = 8                # descriptor-window margin (full-res px)
    subpixel: bool = True
    # corner/ORB pyramid (ImageUtility.py:31-38)
    n_levels: int = 8
    scale_factor: float = 1.2
    first_level: int = 0
    fast_threshold: float = 20.0
    edge_threshold: int = 31
    dtype: str = "float32"         # conv/response dtype; box-filter integral
                                   # images always accumulate in float32
    octave_topk_decay: int = 4     # per-octave candidate budget divisor:
                                   # octave o keeps max_kp/decay^o candidates
                                   # (floor 1024 — coarse octaves carry the
                                   # blob-sparse sets, e.g. zirconTEM).  4
                                   # matches the 4x area shrink per octave,
                                   # so candidate DENSITY stays constant;
                                   # descriptor cost drops ~2x vs. a flat
                                   # budget.  1 = legacy flat budget.


def _gauss_kernels(sigma: float, radius: int):
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    dg = -x / sigma ** 2 * g                     # first derivative
    ddg = (x ** 2 / sigma ** 4 - 1.0 / sigma ** 2) * g  # second derivative
    return (g.astype(np.float32), dg.astype(np.float32), ddg.astype(np.float32))


def _sep_conv2(x: jnp.ndarray, krow: np.ndarray, kcol: np.ndarray) -> jnp.ndarray:
    """Separable 2-D correlation on (..., H, W), reflect-edge padding."""
    r = len(krow) // 2
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(r, r), (0, 0)], mode="edge")
    kr = jnp.asarray(krow, x.dtype)
    out = sum(xp[..., i:i + x.shape[-2], :] * kr[i] for i in range(len(krow)))
    c = len(kcol) // 2
    xp = jnp.pad(out, [(0, 0)] * (x.ndim - 2) + [(0, 0), (c, c)], mode="edge")
    kc = jnp.asarray(kcol, x.dtype)
    return sum(xp[..., :, i:i + x.shape[-1]] * kc[i] for i in range(len(kcol)))


def hessian_response(images: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Scale-normalized determinant-of-Hessian response at one scale.

    DoH = sigma^4 * (Lxx*Lyy - Lxy^2); the SURF box filters approximate
    exactly these second derivatives (Bay et al.; reference GPU analog
    myGpuFeatures.cpp:77 SURF_CUDA hessianThreshold).
    """
    radius = max(2, int(math.ceil(3.0 * sigma)))
    g, dg, ddg = _gauss_kernels(sigma, radius)
    lxx = _sep_conv2(images, g, ddg)
    lyy = _sep_conv2(images, ddg, g)
    lxy = _sep_conv2(images, dg, dg)
    return (sigma ** 4) * (lxx * lyy - lxy * lxy)


# --------------------------------------------------------------------------
# SURF integral-image box-filter response (reference detector parity)
# --------------------------------------------------------------------------

def _integral_pad(x: jnp.ndarray, pad: int) -> jnp.ndarray:
    """Zero-padded summed-area table: (..., H+2p+1, W+2p+1)."""
    nb = [(0, 0)] * (x.ndim - 2)
    xp = jnp.pad(x, nb + [(pad, pad), (pad, pad)])
    ii = jnp.cumsum(jnp.cumsum(xp, axis=-2), axis=-1)
    return jnp.pad(ii, nb + [(1, 0), (1, 0)])


def _box(ii: jnp.ndarray, p: int, h: int, w: int,
         r0: int, r1: int, c0: int, c1: int) -> jnp.ndarray:
    """Dense box sums over rows [r0, r1] x cols [c0, c1] INCLUSIVE, offsets
    relative to each pixel; returns (..., h, w)."""
    a, b = p + r0, p + r1 + 1
    c, d = p + c0, p + c1 + 1
    return (ii[..., b:b + h, d:d + w] - ii[..., a:a + h, d:d + w]
            - ii[..., b:b + h, c:c + w] + ii[..., a:a + h, c:c + w])


def box_hessian_response(images: jnp.ndarray, size: int) -> jnp.ndarray:
    """SURF box-filter determinant-of-Hessian at one filter size.

    Geometry of Bay et al. / cv2.xfeatures2d.SURF (the reference's actual
    detector, ImageUtility.py:255-262): size = 9 + 6k; lobe L = size // 3;
    Dyy = three (L x (2L-1)) lobes weighted (1, -2, 1); Dxy = four LxL
    corner boxes; responses area-normalized (1/size^2 each), and
    det = Dxx*Dyy - (0.9*Dxy)^2.
    """
    L = size // 3
    half = size // 2
    p = size  # padding covers every box offset
    h, w = images.shape[-2], images.shape[-1]
    x = images.astype(jnp.float32)
    ii = _integral_pad(x, p)
    # Dyy: cols [-(L-1), L-1]; row lobes [-half, -half+L-1], [-half+L,
    # -half+2L-1], [-half+2L, half]
    cw = (-(L - 1), L - 1)
    dyy = (_box(ii, p, h, w, -half, -half + L - 1, *cw)
           - 2.0 * _box(ii, p, h, w, -half + L, -half + 2 * L - 1, *cw)
           + _box(ii, p, h, w, -half + 2 * L, half, *cw))
    dxx = (_box(ii, p, h, w, *cw, -half, -half + L - 1)
           - 2.0 * _box(ii, p, h, w, *cw, -half + L, -half + 2 * L - 1)
           + _box(ii, p, h, w, *cw, -half + 2 * L, half))
    dxy = (_box(ii, p, h, w, -L, -1, 1, L) + _box(ii, p, h, w, 1, L, -L, -1)
           - _box(ii, p, h, w, -L, -1, -L, -1) - _box(ii, p, h, w, 1, L, 1, L))
    inv = 1.0 / (size * size)
    dxx, dyy, dxy = dxx * inv, dyy * inv, dxy * inv
    return dxx * dyy - (0.9 * dxy) * (0.9 * dxy)


def octave_response(images: jnp.ndarray, params: DetectParams) -> jnp.ndarray:
    """Layer-max blob response for ONE octave's (pooled) image."""
    if params.box_filter:
        resp = box_hessian_response(images, 9)
        for l in range(1, params.n_octave_layers):
            resp = jnp.maximum(resp, box_hessian_response(images, 9 + 6 * l))
        return resp
    spacing = 2.0 ** (1.0 / max(params.n_octave_layers, 1))
    resp = hessian_response(images, params.base_sigma)
    for l in range(1, params.n_octave_layers):
        resp = jnp.maximum(
            resp, hessian_response(images, params.base_sigma * spacing ** l))
    return resp


# --------------------------------------------------------------------------
# FAST-9 + Harris corner response (ORB parity)
# --------------------------------------------------------------------------

# 16-point Bresenham circle of radius 3 (FAST's test circle)
_FAST_CIRCLE = [(3, 0), (3, 1), (2, 2), (1, 3), (0, 3), (-1, 3), (-2, 2),
                (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3), (0, -3),
                (1, -3), (2, -2), (3, -1)]


def _shift2(x: jnp.ndarray, dr: int, dc: int) -> jnp.ndarray:
    """Edge-replicated shift: out[p] = x[p + (dr, dc)]."""
    h, w = x.shape[-2], x.shape[-1]
    m = 3
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(m, m), (m, m)], mode="edge")
    return xp[..., m + dr:m + dr + h, m + dc:m + dc + w]


def fast9_mask(images: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """True FAST-9 segment test: 9 contiguous circle pixels all brighter
    (or all darker) than center by > threshold.  Dense, branch-free: 16
    shifted diffs -> contiguous-arc tests via a min3/min9 reduction tree."""
    x = images if jnp.issubdtype(images.dtype, jnp.floating) \
        else images.astype(jnp.float32)
    diffs = [_shift2(x, dr, dc) - x for dr, dc in _FAST_CIRCLE]
    bright = [d > threshold for d in diffs]
    dark = [d < -threshold for d in diffs]

    def arc9(flags: List[jnp.ndarray]) -> jnp.ndarray:
        # all-of-3 partial arcs, circular
        a3 = [flags[i] & flags[(i + 1) % 16] & flags[(i + 2) % 16]
              for i in range(16)]
        out = None
        for s in range(16):
            full = a3[s] & a3[(s + 3) % 16] & a3[(s + 6) % 16]
            out = full if out is None else (out | full)
        return out

    return arc9(bright) | arc9(dark)


def harris_response(images: jnp.ndarray) -> jnp.ndarray:
    """Harris corner score (ORB ranks FAST corners by exactly this)."""
    sob = np.array([1.0, 0.0, -1.0], np.float32)
    avg = np.array([0.25, 0.5, 0.25], np.float32)
    x = images if jnp.issubdtype(images.dtype, jnp.floating) \
        else images.astype(jnp.float32)
    ix = _sep_conv2(x, avg, sob)
    iy = _sep_conv2(x, sob, avg)
    box = np.ones(5, np.float32) / 5.0
    sxx = _sep_conv2(ix * ix, box, box)
    syy = _sep_conv2(iy * iy, box, box)
    sxy = _sep_conv2(ix * iy, box, box)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - 0.04 * tr * tr


def fast_corner_response(images: jnp.ndarray) -> jnp.ndarray:
    """Back-compat alias: plain Harris response (no FAST gate)."""
    return harris_response(images)


# --------------------------------------------------------------------------
# NMS, sub-pixel refinement, candidate selection
# --------------------------------------------------------------------------

def _nms3(resp: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-maximum suppression mask on (..., H, W)."""
    neg = jnp.asarray(-jnp.inf, resp.dtype)
    p = jnp.pad(resp, [(0, 0)] * (resp.ndim - 2) + [(1, 1), (1, 1)],
                constant_values=neg)
    m = resp
    for di in range(3):
        for dj in range(3):
            if di == 1 and dj == 1:
                continue
            m = jnp.maximum(m, p[..., di:di + resp.shape[-2],
                                 dj:dj + resp.shape[-1]])
    return resp >= m  # ties keep both (filtered later by score ordering)


def _gather3x3(m: jnp.ndarray, rows: jnp.ndarray, cols: jnp.ndarray
               ) -> jnp.ndarray:
    """(K,) int centers -> (K, 3, 3) windows of (H, W) map, edge-clipped."""
    starts = jnp.stack([rows - 1, cols - 1], axis=-1)
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2), collapsed_slice_dims=(), start_index_map=(0, 1))
    return jax.lax.gather(m, starts, dn, slice_sizes=(3, 3),
                          mode=jax.lax.GatherScatterMode.CLIP)


def refine_subpixel(raw: jnp.ndarray, rows: jnp.ndarray, cols: jnp.ndarray
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Quadratic (parabola-vertex) sub-pixel offsets from the RAW (un-NMS'd)
    response map.  Returns (drow, dcol) in [-0.5, 0.5]."""
    win = _gather3x3(raw, rows, cols)
    c = win[:, 1, 1]

    def axis_off(m, p):
        den = 2.0 * (m + p - 2.0 * c)
        off = jnp.where(jnp.abs(den) > 1e-12, (m - p) / den, 0.0)
        return jnp.clip(off, -0.5, 0.5)

    return (axis_off(win[:, 0, 1], win[:, 2, 1]),
            axis_off(win[:, 1, 0], win[:, 1, 2]))


def select_candidates(raw: jnp.ndarray, score: jnp.ndarray, k: int,
                      border_rc: Tuple[int, int, int, int],
                      subpixel: bool
                      ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Top-k of an NMS-masked score map -> sub-pixel (rows, cols, scores).

    ``raw`` is the pre-NMS response (3x3 neighborhoods for refinement);
    ``border_rc`` = (r_lo, r_hi, c_lo, c_hi) valid half-open bounds.
    """
    h, w = score.shape
    r_lo, r_hi, c_lo, c_hi = border_rc
    ri = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = (ri >= r_lo) & (ri < r_hi) & (ci >= c_lo) & (ci < c_hi)
    score = jnp.where(inside, score, 0.0)
    kk = min(k, h * w)
    top_s, top_i = jax.lax.top_k(score.reshape(-1), kk)
    r = (top_i // w).astype(jnp.int32)
    c = (top_i % w).astype(jnp.int32)
    if subpixel:
        dr, dc = refine_subpixel(raw, r, c)
    else:
        dr = dc = jnp.zeros_like(top_s)
    rows = r.astype(jnp.float32) + dr
    cols = c.astype(jnp.float32) + dc
    if kk < k:
        pad = k - kk
        rows = jnp.pad(rows, (0, pad))
        cols = jnp.pad(cols, (0, pad))
        top_s = jnp.pad(top_s, (0, pad))
    return rows, cols, top_s


def octave_budget(max_kp: int, octave: int, decay: int) -> int:
    """Candidate capacity for one octave under the density-matched decay."""
    if decay <= 1 or octave == 0:
        return max_kp
    return max(max_kp // decay ** octave, min(1024, max_kp))


def level_budget(max_kp: int, level: int, scale_factor: float,
                 decay: int) -> int:
    """ORB-pyramid analog: budget follows the level's area shrink."""
    if decay <= 1 or level == 0:
        return max_kp
    area_shrink = scale_factor ** (2 * level)
    return max(int(max_kp / area_shrink), min(1024, max_kp))


def _pool2(x: jnp.ndarray) -> jnp.ndarray:
    """2x2 mean pool on (..., H, W) (H, W truncated to even).

    reduce_window, not reshape-mean: one windowed reduction with no
    reshape of the minor dimension."""
    h2 = (x.shape[-2] // 2) * 2
    w2 = (x.shape[-1] // 2) * 2
    x = x[..., :h2, :w2]
    ones = (1,) * (x.ndim - 2)
    y = jax.lax.reduce_window(x, np.float32(0) if x.dtype == jnp.float32
                              else jnp.zeros((), x.dtype),
                              jax.lax.add, ones + (2, 2), ones + (2, 2),
                              "VALID")
    return y * 0.25


# --------------------------------------------------------------------------
# Full detectors (single image; batch = vmap/lax.map by the caller)
# --------------------------------------------------------------------------

def detect_image_hessian(img: jnp.ndarray, max_kp: int, params: DetectParams
                         ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Multi-octave blob detection on ONE (H, W) image."""
    x = img.astype(jnp.dtype(params.dtype))
    h, w = x.shape
    cand = []
    xo = x
    for o in range(params.n_octaves):
        if o > 0:
            if min(xo.shape) < 32:
                break
            xo = _pool2(xo)
        ho, wo = xo.shape
        raw = octave_response(xo, params).astype(jnp.float32)
        keep = _nms3(raw) & (raw > params.threshold)
        score = jnp.where(keep, raw, 0.0)
        bo = max(1, -(-params.border // (1 << o)))
        bud = octave_budget(max_kp, o, params.octave_topk_decay)
        r, c, s = select_candidates(raw, score, bud,
                                    (bo, ho - bo, bo, wo - bo),
                                    params.subpixel)
        # octave coords -> full-res: pooled pixel centers sit at
        # 2^o * c + (2^o - 1) / 2
        f = float(1 << o)
        cand.append((r * f + (f - 1) / 2, c * f + (f - 1) / 2, s))
    rows = jnp.concatenate([t[0] for t in cand])
    cols = jnp.concatenate([t[1] for t in cand])
    scores = jnp.concatenate([t[2] for t in cand])
    if rows.shape[0] < max_kp:
        pad = max_kp - rows.shape[0]
        rows = jnp.pad(rows, (0, pad))
        cols = jnp.pad(cols, (0, pad))
        scores = jnp.pad(scores, (0, pad))
    top_s, top_i = jax.lax.top_k(scores, max_kp)
    return rows[top_i], cols[top_i], top_s


def detect_image_corner(img: jnp.ndarray, max_kp: int, params: DetectParams
                        ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """ORB-style pyramid detection on ONE (H, W) image: FAST-9 gate,
    Harris ranking, ``n_levels`` levels spaced by ``scale_factor``."""
    x = img.astype(jnp.dtype(params.dtype))
    h, w = x.shape
    cand = []
    for lvl in range(params.first_level, params.n_levels):
        s = params.scale_factor ** lvl
        hs, ws = int(round(h / s)), int(round(w / s))
        if min(hs, ws) <= 2 * params.edge_threshold + 8:
            break
        xl = x if lvl == 0 else jax.image.resize(x, (hs, ws), "linear")
        gate = fast9_mask(xl, params.fast_threshold)
        raw = harris_response(xl).astype(jnp.float32)
        score = jnp.where(_nms3(raw) & gate & (raw > 0), raw, 0.0)
        b = params.edge_threshold
        bud = level_budget(max_kp, lvl - params.first_level,
                           params.scale_factor, params.octave_topk_decay)
        r, c, sc = select_candidates(raw, score, bud,
                                     (b, hs - b, b, ws - b),
                                     params.subpixel)
        # resize maps level coord c -> full coord (c + 0.5) * s - 0.5
        cand.append(((r + 0.5) * s - 0.5, (c + 0.5) * s - 0.5, sc))
    rows = jnp.concatenate([t[0] for t in cand])
    cols = jnp.concatenate([t[1] for t in cand])
    scores = jnp.concatenate([t[2] for t in cand])
    if rows.shape[0] < max_kp:
        pad = max_kp - rows.shape[0]
        rows = jnp.pad(rows, (0, pad))
        cols = jnp.pad(cols, (0, pad))
        scores = jnp.pad(scores, (0, pad))
    top_s, top_i = jax.lax.top_k(scores, max_kp)
    return rows[top_i], cols[top_i], top_s


def detect_image(img: jnp.ndarray, max_kp: int, params: DetectParams):
    if params.family == "corner":
        return detect_image_corner(img, max_kp, params)
    return detect_image_hessian(img, max_kp, params)


@functools.partial(jax.jit, static_argnames=("max_kp", "params"))
def detect_batch(images: jnp.ndarray, max_kp: int, params: DetectParams
                 ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Detect up to ``max_kp`` keypoints per image of a (P, H, W) batch.

    Returns (rows, cols, scores): each (P, max_kp) float32, sub-pixel
    positions; padded entries have score <= 0 (invalid).
    """
    return jax.vmap(lambda im: detect_image(im, max_kp, params))(images)


# --------------------------------------------------------------------------
# Fused detect+describe: descriptors sampled AT THE DETECTION SCALE
# --------------------------------------------------------------------------

def detect_describe_image(img: jnp.ndarray, max_kp: int,
                          params: DetectParams, sparams
                          ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray,
                                     jnp.ndarray]:
    """Detect AND describe one (H, W) image; descriptors are computed on the
    detection octave/level image, so the descriptor window scales with the
    keypoint (what cv2 SIFT/SURF do — a fixed full-res window loses
    distinctiveness for coarse blobs, e.g. the sparse zircon TEM grains).

    Returns (rows, cols, scores, descs) in FULL-RES coordinates, descs
    (max_kp, D).
    """
    from . import describe as describe_mod
    x = img.astype(jnp.dtype(params.dtype))
    cand = []
    if params.family == "corner":
        h, w = x.shape
        for lvl in range(params.first_level, params.n_levels):
            s = params.scale_factor ** lvl
            hs, ws = int(round(h / s)), int(round(w / s))
            if min(hs, ws) <= 2 * params.edge_threshold + 8:
                break
            xl = x if lvl == 0 else jax.image.resize(x, (hs, ws), "linear")
            gate = fast9_mask(xl, params.fast_threshold)
            raw = harris_response(xl).astype(jnp.float32)
            score = jnp.where(_nms3(raw) & gate & (raw > 0), raw, 0.0)
            b = params.edge_threshold
            bud = level_budget(max_kp, lvl - params.first_level,
                               params.scale_factor, params.octave_topk_decay)
            r, c, sc = select_candidates(raw, score, bud,
                                         (b, hs - b, b, ws - b),
                                         params.subpixel)
            d = describe_mod.describe_batch(xl[None], r[None], c[None],
                                            sparams)[0]
            cand.append(((r + 0.5) * s - 0.5, (c + 0.5) * s - 0.5, sc, d))
    else:
        xo = x
        octave_imgs = []
        for o in range(params.n_octaves):
            if o > 0:
                # the octave image must still fit a descriptor window
                # (oriented gather patch is 29 px)
                if min(xo.shape) < 64:
                    break
                xo = _pool2(xo)
            ho, wo = xo.shape
            raw = octave_response(xo, params).astype(jnp.float32)
            keep = _nms3(raw) & (raw > params.threshold)
            score = jnp.where(keep, raw, 0.0)
            bo = max(1, -(-params.border // (1 << o)))
            bud = octave_budget(max_kp, o, params.octave_topk_decay)
            r, c, s = select_candidates(raw, score, bud,
                                        (bo, ho - bo, bo, wo - bo),
                                        params.subpixel)
            f = float(1 << o)
            cand.append((r * f + (f - 1) / 2, c * f + (f - 1) / 2, s,
                         r, c, jnp.full(r.shape, o, jnp.int32)))
            octave_imgs.append(xo)
        # select-then-describe: global top-K first, one pyramid-atlas
        # describe over the survivors (the octave budgets sum to ~2x
        # max_kp; descriptor gathers are the pool's dominant cost)
        parts = [jnp.concatenate([t[i] for t in cand]) for i in range(6)]
        rows, cols, scores, r_loc, c_loc, oct_ids = parts
        if rows.shape[0] < max_kp:
            pad = max_kp - rows.shape[0]
            rows, cols, scores, r_loc, c_loc = (
                jnp.pad(a, (0, pad))
                for a in (rows, cols, scores, r_loc, c_loc))
            oct_ids = jnp.pad(oct_ids, (0, pad))
        top_s, top_i = jax.lax.top_k(scores, max_kp)
        descs = describe_mod.describe_from_pyramid(
            octave_imgs, r_loc[top_i], c_loc[top_i], oct_ids[top_i],
            sparams)
        return rows[top_i], cols[top_i], top_s, descs
    rows = jnp.concatenate([t[0] for t in cand])
    cols = jnp.concatenate([t[1] for t in cand])
    scores = jnp.concatenate([t[2] for t in cand])
    descs = jnp.concatenate([t[3] for t in cand])
    if rows.shape[0] < max_kp:
        pad = max_kp - rows.shape[0]
        rows = jnp.pad(rows, (0, pad))
        cols = jnp.pad(cols, (0, pad))
        scores = jnp.pad(scores, (0, pad))
        descs = jnp.pad(descs, ((0, pad), (0, 0)))
    top_s, top_i = jax.lax.top_k(scores, max_kp)
    return (rows[top_i], cols[top_i], top_s,
            jnp.take(descs, top_i, axis=0))
