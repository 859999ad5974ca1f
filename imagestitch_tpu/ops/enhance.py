"""Contrast enhancement: histogram equalization and CLAHE.

Batched replacements for the reference's optional preprocessing
(reference: Stitcher.py:269-276, :327-334 — cv2.equalizeHist /
cv2.createCLAHE with clipLimit/tileGridSize from ImageUtility.py:47-50).

Histograms are built with one-hot matmuls (matmul-friendly, no scatter storms);
CLAHE interpolates per-tile LUTs bilinearly, matching OpenCV's scheme (clip,
uniform redistribution, half-tile-centered interpolation grid).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


def _histogram256(x: jnp.ndarray) -> jnp.ndarray:
    """(N,) uint8 values -> (256,) counts via one-hot contraction."""
    oh = jax.nn.one_hot(x.astype(jnp.int32), 256, dtype=jnp.float32)
    return jnp.sum(oh, axis=0)


def _equalize_lut(hist: jnp.ndarray, total: jnp.ndarray) -> jnp.ndarray:
    """cv2.equalizeHist LUT semantics: first nonzero bin maps to 0, scale =
    255 / (total - count_of_first_nonzero_bin)."""
    nz = hist > 0
    first = jnp.argmax(nz)                       # first nonzero bin
    h0 = hist[first]
    scale = 255.0 / jnp.maximum(total - h0, 1.0)
    cdf = jnp.cumsum(hist)
    # cv2: lut[i] = round((cdf[i] - cdf[first]) * scale); lut[first] = 0
    lut = jnp.round((cdf - cdf[first]) * scale)
    lut = jnp.clip(lut, 0, 255)
    # constant image: identity map
    lut = jnp.where(total == h0, jnp.arange(256, dtype=lut.dtype), lut)
    return lut.astype(jnp.uint8)


@jax.jit
def equalize_hist(image: jnp.ndarray) -> jnp.ndarray:
    """(H, W) uint8 -> equalized uint8 (cv2.equalizeHist semantics)."""
    h, w = image.shape
    hist = _histogram256(image.reshape(-1))
    lut = _equalize_lut(hist, jnp.float32(h * w))
    return lut[image.astype(jnp.int32)]


@functools.partial(jax.jit, static_argnames=("tiles", "clip_limit"))
def clahe(image: jnp.ndarray, clip_limit: float = 20.0, tiles: int = 5
          ) -> jnp.ndarray:
    """Contrast-limited adaptive histogram equalization.

    (H, W) uint8 -> uint8; ``tiles`` x ``tiles`` grid (reference tileSize=5).
    EXACT cv2.createCLAHE semantics (opencv clahe.cpp):
    REFLECT_101 padding to whole tiles, INTEGER clip limit
    max(int(clipLimit*area/256), 1), integer excess redistribution
    (uniform floor + stride-walked residual, leftover dropped), LUT =
    saturate-rounded cumsum * 255/area, half-tile-centered bilinear blend.
    Validated bit-exact against cv2 on real micrograph tiles
    (tests/test_enhance.py).
    """
    h, w = image.shape
    if h % tiles == 0 and w % tiles == 0:
        th, tw = h // tiles, w // tiles
    else:
        # cv2 quirk (clahe.cpp): in the non-divisible branch BOTH dims pad
        # by ``tiles - dim % tiles`` with NO mod-zero guard — a divisible
        # dimension still gains one full extra tile of REFLECT_101 border
        th = (h + tiles - h % tiles) // tiles
        tw = (w + tiles - w % tiles) // tiles
    hp, wp = th * tiles, tw * tiles
    img = jnp.pad(image, ((0, hp - h), (0, wp - w)), mode="reflect")
    t = img.reshape(tiles, th, tiles, tw).transpose(0, 2, 1, 3)
    t = t.reshape(tiles * tiles, th * tw)                     # per-tile pixels

    hists = jax.vmap(_histogram256)(t)                        # (T^2, 256)
    area = th * tw
    limit = float(max(int(clip_limit * area / 256.0), 1))     # cv2: int()
    clipped = jnp.minimum(hists, limit)
    excess = jnp.sum(hists - clipped, axis=1, keepdims=True)  # integral
    # cv2 redistribution: every bin gets floor(excess/256); the remainder
    # walks bins 0, step, 2*step, ... (step = max(256//residual, 1)) adding
    # 1 until spent or the walk leaves [0, 256) — leftover is DROPPED
    batch = jnp.floor(excess / 256.0)
    residual = excess - batch * 256.0
    step = jnp.maximum(jnp.floor(256.0 / jnp.maximum(residual, 1.0)), 1.0)
    bins = jnp.arange(256, dtype=jnp.float32)[None, :]
    bump = ((jnp.floor_divide(bins, step) * step == bins)
            & (jnp.floor_divide(bins, step) < residual)).astype(jnp.float32)
    clipped = clipped + batch + bump

    scale = 255.0 / area
    luts = jnp.clip(jnp.round(jnp.cumsum(clipped, axis=1) * scale), 0, 255)
    luts = luts.reshape(tiles, tiles, 256)

    # bilinear interpolation between the four surrounding tile LUTs
    ri = jnp.arange(hp, dtype=jnp.float32)
    ci = jnp.arange(wp, dtype=jnp.float32)
    ty = ri / th - 0.5
    tx = ci / tw - 0.5
    y0 = jnp.clip(jnp.floor(ty), 0, tiles - 1).astype(jnp.int32)
    x0 = jnp.clip(jnp.floor(tx), 0, tiles - 1).astype(jnp.int32)
    y1 = jnp.clip(y0 + 1, 0, tiles - 1)
    x1 = jnp.clip(x0 + 1, 0, tiles - 1)
    fy = jnp.clip(ty - y0, 0.0, 1.0)[:, None]
    fx = jnp.clip(tx - x0, 0.0, 1.0)[None, :]

    v = img.astype(jnp.int32)
    g = lambda yy, xx: luts[yy[:, None], xx[None, :], v]
    out = ((1 - fy) * (1 - fx) * g(y0, x0) + (1 - fy) * fx * g(y0, x1) +
           fy * (1 - fx) * g(y1, x0) + fy * fx * g(y1, x1))
    return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)[:h, :w]


@functools.partial(jax.jit, static_argnames=("use_clahe", "tiles", "clip_limit"))
def enhance_batch(images: jnp.ndarray, use_clahe: bool, clip_limit: float,
                  tiles: int) -> jnp.ndarray:
    """(P, H, W) uint8 batch enhancement dispatcher (Stitcher.py:269-276)."""
    if use_clahe:
        return jax.vmap(lambda im: clahe(im, clip_limit, tiles))(images)
    return jax.vmap(equalize_hist)(images)
