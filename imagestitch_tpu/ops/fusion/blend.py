"""Fusion kernels: average / maximum / minimum / fade / trigonometric.

Vectorized replacements for the reference's fusers
(reference: ImageFusion.py:12-41 simple fusers, :192-244 fade, :246-293
trigonometric) and the pre-fill + dispatch semantics of ``fuseImage``
(reference: Stitcher.py:488-525).

All kernels operate on int32 regions that carry the reference's ``-1``
background sentinel, and return uint8.  Shapes are static per rect
configuration; the handful of distinct overlap-rect shapes in a dataset each
compile once.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from .weights import corner_fade_weights, plain_fade_weights, _valid_mask


def _prefill_background(image_a: jnp.ndarray, image_b: jnp.ndarray
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Background elimination for the non-fade modes.

    Exact semantics of Stitcher.py:498-504: map -1 sentinels to 0, then fill
    every 0-valued element of one region from the other.  (Note the reference
    quirk: true black pixels are treated as background too.)
    """
    a = jnp.where(image_a == -1, 0, image_a)
    b = jnp.where(image_b == -1, 0, image_b)
    a_f = jnp.where(a == 0, b, a)
    b_f = jnp.where(b == 0, a_f, b)  # ref fills B after A was already filled
    return a_f, b_f


def fuse_average(image_a: jnp.ndarray, image_b: jnp.ndarray) -> jnp.ndarray:
    """(A + B) / 2 with float truncation (ImageFusion.py:12-21)."""
    return ((image_a + image_b) // 2).astype(jnp.uint8)


def fuse_maximum(image_a: jnp.ndarray, image_b: jnp.ndarray) -> jnp.ndarray:
    return jnp.maximum(image_a, image_b).astype(jnp.uint8)


def fuse_minimum(image_a: jnp.ndarray, image_b: jnp.ndarray) -> jnp.ndarray:
    return jnp.minimum(image_a, image_b).astype(jnp.uint8)


def _fade_weights(image_a: jnp.ndarray, drow, dcol, color: bool
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Weight selection shared by fade and trigonometric fusion.

    ImageFusion.py:209-239: plain separable ramps when >65% of A is valid,
    else the corner-quadrant weights.
    """
    hw = (image_a.shape[0], image_a.shape[1])
    valid_frac = jnp.mean((image_a > -1).astype(jnp.float32))
    wa_plain, wb_plain = plain_fade_weights(hw, drow, dcol)
    wa_corner, wb_corner = corner_fade_weights(image_a, color)
    plain = valid_frac > 0.65
    wa = jnp.where(plain, wa_plain, wa_corner)
    wb = jnp.where(plain, wb_plain, wb_corner)
    return wa, wb


def _apply_weights(image_a: jnp.ndarray, image_b: jnp.ndarray,
                   wa: jnp.ndarray, wb: jnp.ndarray, color: bool) -> jnp.ndarray:
    """A[A<0] <- B; blend; clamp [0,255] (ImageFusion.py:240-243)."""
    a = jnp.where(image_a < 0, image_b, image_a)
    if color:
        wa = wa[..., None]
        wb = wb[..., None]
    res = wa * a.astype(jnp.float32) + wb * image_b.astype(jnp.float32)
    return jnp.clip(res, 0, 255).astype(jnp.uint8)


def fuse_fade(image_a: jnp.ndarray, image_b: jnp.ndarray, drow, dcol,
              color: bool) -> jnp.ndarray:
    """fadeInAndFadeOut fusion (ImageFusion.py:192-244)."""
    wa, wb = _fade_weights(image_a, drow, dcol, color)
    return _apply_weights(image_a, image_b, wa, wb, color)


def fuse_trigonometric(image_a: jnp.ndarray, image_b: jnp.ndarray, drow, dcol,
                       color: bool) -> jnp.ndarray:
    """sin^2-weighted fusion (ImageFusion.py:246-293).

    Note the reference's plain-ramp orientation for this mode mirrors the
    fade ramps (the dy>=0 branch assigns ascending to A instead of
    descending — ImageFusion.py:265-270); replicated exactly.
    """
    row, col = image_a.shape[0], image_a.shape[1]
    valid_frac = jnp.mean((image_a > -1).astype(jnp.float32))
    # trigonometric plain ramps are the mirror of the fade ones
    if col <= row:
        j = jnp.arange(col, dtype=jnp.float32)
        wa_p = jnp.where(dcol >= 0, j / col, (col - j) / col)
        wb_p = jnp.where(dcol >= 0, (col - 1 - j) / col, (j + 1) / col)
        wa_p = jnp.broadcast_to(wa_p[None, :], (row, col))
        wb_p = jnp.broadcast_to(wb_p[None, :], (row, col))
    else:
        i = jnp.arange(row, dtype=jnp.float32)
        wa_p = jnp.where(drow <= 0, i / row, (row - i) / row)
        wb_p = jnp.where(drow <= 0, (row - 1 - i) / row, (i + 1) / row)
        wa_p = jnp.broadcast_to(wa_p[:, None], (row, col))
        wb_p = jnp.broadcast_to(wb_p[:, None], (row, col))
    wa_c, wb_c = corner_fade_weights(image_a, color)
    plain = valid_frac > 0.65
    wa = jnp.where(plain, wa_p, wa_c)
    wa = jnp.sin(wa * jnp.pi / 2.0) ** 2  # ImageFusion.py:286
    wb = 1.0 - wa
    return _apply_weights(image_a, image_b, wa, wb, color)


@functools.partial(jax.jit, static_argnames=("method", "color"))
def fuse_region(image_a: jnp.ndarray, image_b: jnp.ndarray, drow, dcol,
                method: str, color: bool) -> jnp.ndarray:
    """The ``fuseImage`` dispatcher (Stitcher.py:488-525) for elementwise modes.

    ``image_a``/``image_b`` are int32 with -1 sentinels; drow/dcol is the
    *pairwise* (un-rectified) offset of the pair being fused.
    multiBandBlending / optimalSeamLine dispatch lives in pyramid.py/seam.py
    (they need multi-scale machinery).
    """
    if method in ("average", "maximum", "minimum", "notFuse"):
        a, b = _prefill_background(image_a, image_b)
        if method == "notFuse":
            return b.astype(jnp.uint8)
        if method == "average":
            return fuse_average(a, b)
        if method == "maximum":
            return fuse_maximum(a, b)
        return fuse_minimum(a, b)
    if method == "fadeInAndFadeOut":
        return fuse_fade(image_a, image_b, drow, dcol, color)
    if method == "trigonometric":
        return fuse_trigonometric(image_a, image_b, drow, dcol, color)
    raise ValueError(f"unknown elementwise fusion method: {method}")


def fuse_region_padded(image_a: jnp.ndarray, image_b: jnp.ndarray,
                       drow, dcol, orow, ocol, rh, rw,
                       method: str, color: bool) -> jnp.ndarray:
    """``fuse_region`` on a PADDED window: the true rect spans rows
    [orow, orow+rh) x cols [ocol, ocol+rw) (traced scalars).

    Outside the true rect the result equals ``image_b`` (the canvas content
    after the paste), so writing the whole padded window back is a no-op
    there — this lets composition bucket rect shapes and reuse one compiled
    program per bucket.  All decision statistics (valid fraction, quadrant
    counts, boundary scans) and ramps are evaluated with rect-local
    coordinates and dynamic dims — identical math to the static kernels
    (equivalence-tested in tests/test_fusion.py).
    """
    from .weights import (corner_fade_weights_dyn, plain_fade_weights_dyn,
                          _valid_mask)
    bh, bw = image_a.shape[0], image_a.shape[1]
    il = jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 0) - orow
    jl = jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 1) - ocol
    in_rect = (il >= 0) & (il < rh) & (jl >= 0) & (jl < rw)
    mask = in_rect[..., None] if color else in_rect

    if method in ("average", "maximum", "minimum", "notFuse"):
        a, b = _prefill_background(image_a, image_b)
        if method == "notFuse":
            fused = b.astype(jnp.uint8)
        elif method == "average":
            fused = fuse_average(a, b)
        elif method == "maximum":
            fused = fuse_maximum(a, b)
        else:
            fused = fuse_minimum(a, b)
    elif method in ("fadeInAndFadeOut", "trigonometric"):
        # mark padded area invalid so validity statistics see only the rect
        neg1 = jnp.full_like(image_a, -1)
        a_rect = jnp.where(mask, image_a, neg1)
        # static version: mean over every element (channels included)
        n_el = (rh * rw).astype(jnp.float32) * (3.0 if color else 1.0)
        valid_frac = jnp.sum((a_rect > -1) & mask) / n_el
        wa_p, wb_p = plain_fade_weights_dyn((bh, bw), orow, ocol, rh, rw,
                                            drow, dcol)
        if method == "trigonometric":
            # trig plain ramps mirror the fade ones (blend.fuse_trigonometric)
            rhf = rh.astype(jnp.float32)
            rwf = rw.astype(jnp.float32)
            i1 = il.astype(jnp.float32)
            j1 = jl.astype(jnp.float32)
            wa_h = jnp.where(dcol >= 0, j1 / rwf, (rwf - j1) / rwf)
            wa_v = jnp.where(drow <= 0, i1 / rhf, (rhf - i1) / rhf)
            wa_p = jnp.where(rw <= rh, wa_h, wa_v)
        wa_c, wb_c = corner_fade_weights_dyn(a_rect, color, orow, ocol, rh, rw)
        plain = valid_frac > 0.65
        wa = jnp.where(plain, wa_p, wa_c)
        if method == "trigonometric":
            wa = jnp.sin(wa * jnp.pi / 2.0) ** 2
            wb = 1.0 - wa
        else:
            wb = jnp.where(plain, wb_p, wb_c)
        fused = _apply_weights(image_a, image_b, wa, wb, color)
    else:
        raise ValueError(f"unpaddable fusion method: {method}")

    # outside the true rect: return the post-paste canvas content VERBATIM
    # (including -1 sentinels) so the padded write-back is a no-op there
    return jnp.where(mask, fused.astype(jnp.int32), image_b)
