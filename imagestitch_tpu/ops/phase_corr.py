"""Batched FFT phase correlation.

Batched replacement for the reference's per-attempt
``cv2.phaseCorrelate(np.float64(roiA), np.float64(roiB))`` call
(reference: Stitcher.py:230) and the vestigial GPU-FFT path
(reference: Stitcher.py:184-203, whose ``self.phase`` module is missing).

Semantics replicate OpenCV's phase correlation pipeline so offsets bit-match
after the caller's int() truncation:
  1. zero-pad each image to the optimal (5-smooth) DFT size,
  2. cross-power spectrum  F(a) * conj(F(b)) / |.|,
  3. inverse FFT, fftshift,
  4. peak + 5x5 weighted centroid (sub-pixel), response = window mass / (M*N),
  5. shift = center - centroid.

Differences from the reference by design: float32 instead of float64 (GPU
float64 runs at a fraction of the float32 rate; validated to < 1e-2 px vs
cv2 in tests), and the whole pair
batch runs in ONE device dispatch (vmap over pairs) instead of one host
round-trip per attempt.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def optimal_dft_size(n: int) -> int:
    """Smallest 5-smooth integer >= n (cv2.getOptimalDFTSize semantics)."""
    if n <= 0:
        return 1
    best = None
    p2 = 1
    while p2 < 2 * n:
        p23 = p2
        while p23 < 2 * n:
            p235 = p23
            while p235 < n:
                p235 *= 5
            if best is None or p235 < best:
                best = p235
            p23 *= 3
        p2 *= 2
    return best


def _weighted_centroid_5x5(c: jnp.ndarray, peak_r: jnp.ndarray, peak_c: jnp.ndarray
                           ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """OpenCV weightedCentroid over a border-clipped 5x5 window.

    Returns (centroid_row, centroid_col, window_sum).  The window is clipped
    (not shifted) at borders, matching cv2's minr/maxr clamping.
    """
    H, W = c.shape
    dr = jnp.arange(-2, 3)
    rows = peak_r + dr                      # (5,)
    cols = peak_c + dr                      # (5,)
    rmask = (rows >= 0) & (rows < H)
    cmask = (cols >= 0) & (cols < W)
    rows_c = jnp.clip(rows, 0, H - 1)
    cols_c = jnp.clip(cols, 0, W - 1)
    win = c[rows_c[:, None], cols_c[None, :]]
    mask = rmask[:, None] & cmask[None, :]
    win = jnp.where(mask, win, 0.0)
    s = jnp.sum(win)
    cr = jnp.sum(win * rows_c[:, None].astype(c.dtype)) / (s + jnp.finfo(c.dtype).tiny)
    cc = jnp.sum(win * cols_c[None, :].astype(c.dtype)) / (s + jnp.finfo(c.dtype).tiny)
    return cr, cc, s


def _phase_correlate_one(a: jnp.ndarray, b: jnp.ndarray, hp: int, wp: int
                         ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Single-pair phase correlation on (h, w) float32 images.

    Returns (shift_col, shift_row, response) — cv2 returns (x, y) with x the
    column shift; the caller maps to the reference's [drow, dcol] order
    (Stitcher.py:231-232 sets offset=[int(y), int(x)]).
    """
    h, w = a.shape
    apad = jnp.zeros((hp, wp), a.dtype).at[:h, :w].set(a)
    bpad = jnp.zeros((hp, wp), b.dtype).at[:h, :w].set(b)
    fa = jnp.fft.rfft2(apad)
    fb = jnp.fft.rfft2(bpad)
    p = fa * jnp.conj(fb)
    mag = jnp.abs(p)
    cps = p / (mag + jnp.finfo(a.dtype).tiny)
    c = jnp.fft.irfft2(cps, s=(hp, wp))
    c = jnp.roll(c, (hp // 2, wp // 2), axis=(0, 1))  # fftshift
    flat_peak = jnp.argmax(c)
    peak_r = (flat_peak // wp).astype(jnp.int32)
    peak_c = (flat_peak % wp).astype(jnp.int32)
    cr, cc, wsum = _weighted_centroid_5x5(c, peak_r, peak_c)
    # cv2 divides its unscaled-IDFT window mass by M*N; jnp.fft.irfft2 already
    # includes the 1/(M*N) factor, so wsum IS cv2's normalized response.
    response = wsum
    center_r = hp / 2.0
    center_c = wp / 2.0
    return center_c - cc, center_r - cr, response


@functools.partial(jax.jit, static_argnames=("hp", "wp"))
def _phase_correlate_batch_jit(a: jnp.ndarray, b: jnp.ndarray, hp: int, wp: int):
    f = jax.vmap(lambda x, y: _phase_correlate_one(x, y, hp, wp))
    return f(a, b)


def phase_correlate_batch(a, b) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched phase correlation.

    a, b: ``(P, h, w)`` arrays (any real dtype; cast to float32 on device).
    Returns host arrays ``(shift_x, shift_y, response)`` of shape ``(P,)``
    with cv2's (x=col, y=row) convention.
    """
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    h, w = a.shape[-2], a.shape[-1]
    hp, wp = optimal_dft_size(h), optimal_dft_size(w)
    sx, sy, resp = _phase_correlate_batch_jit(a, b, hp, wp)
    return np.asarray(sx), np.asarray(sy), np.asarray(resp)
