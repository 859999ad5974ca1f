"""Host-side (numpy, float64) fusion — the reference's exact arithmetic.

The reference blends through numpy float64 (weight matrices are np.ones
defaults and the blend promotes through float64, ImageFusion.py:85-94,
:241-243); the device kernels run float32 (a documented ±1-LSB divergence
on a tiny pixel fraction — docs/ARCHITECTURE.md).
This module is the float64 path: vectorized numpy mirrors of the fusion
kernels, used by the streamed-output color composer
(core/stream_out.compose_color_host) where the blend runs host-side anyway
— making the streamed color panorama REFERENCE-EXACT, not merely
device-equal.

Each function mirrors its jax twin in blend.py/weights.py (which are
oracle-tested against literal reference loops); equivalence of this module
against the same oracles is asserted in tests/test_host_blend.py.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _valid_np(image: np.ndarray, color: bool) -> np.ndarray:
    """(H, W) bool validity — ImageFusion.py:72/80 sentinel test."""
    if color:
        return image.sum(axis=-1) != -3
    return image != -1


def _row_ramp_up_np(n: int, idx: int) -> np.ndarray:
    """positions 0..idx get p/idx, rest 1 (ImageFusion.py:85-88);
    idx==0 -> all ones (the reference's in-loop guard)."""
    out = np.ones(n, np.float64)
    if idx == 0:
        return out
    p = np.arange(min(idx, n - 1) + 1, dtype=np.float64)
    out[:len(p)] = p / idx
    return out


def _row_ramp_down_np(n: int, idx: int) -> np.ndarray:
    """positions idx..n-1 get (n-1-p)/(n-idx-1), rest 1
    (ImageFusion.py:117-120); idx==0 follows the reference's in-loop guard
    (every position from 0, denominator n-2; /0 -> inf)."""
    eff = 1 if idx == 0 else idx
    start = max(min(idx, n), 0)
    out = np.ones(n, np.float64)
    p = np.arange(start, n, dtype=np.float64)
    denom = float(n - eff - 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        out[start:] = (n - 1 - p) / denom if denom != 0 else np.inf
    return out


def corner_vectors_from_stats(quad, first_v, last_v, row_valid,
                              row: int, col: int
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Corner weight factors from one-pass rect statistics.

    ``quad``: 4 positive-element counts in the reference's cmp order
    (ul, ll, lr, ur — ImageFusion.py:56-62); ``first_v``/``last_v``:
    per-column first/last VALID row (-1 when the column has none);
    ``row_valid(ri) -> (col,) bool``: validity of one row on demand.
    Enables the native composer to gather stats in a single C pass
    (isr_rect_stats) while this function keeps the quirk-exact decision
    logic in one place.
    """
    index = int(np.argmin(quad))   # first minimum = list.index(min)
    first_v = np.asarray(first_v)
    last_v = np.asarray(last_v)
    cand_bottom_up = np.where(last_v >= 0, last_v + 1, 0)
    cand_top_down = np.where(first_v >= 0, first_v - 1, 0)

    def select_first_nonzero(cand, order_desc: bool, skip_col0: bool) -> int:
        nz = cand != 0
        if skip_col0:
            nz = nz.copy()
            nz[0] = False
        idxs = np.nonzero(nz)[0]
        if len(idxs) == 0:
            return 0
        return int(cand[idxs[-1] if order_desc else idxs[0]])

    def col_index_after(ri: int, from_right: bool, minus_one: bool) -> int:
        vrow = row_valid(min(max(ri, 0), row - 1))
        idxs = np.nonzero(vrow)[0]
        if len(idxs) == 0:
            return 0
        if from_right:
            return int(idxs[-1]) + 1
        return int(idxs[0]) + (-1 if minus_one else 1)

    if index == 2:    # overlap upper-left (ImageFusion.py:64-94)
        ri = select_first_nonzero(cand_bottom_up, True, True)
        ci = col_index_after(ri, True, False)
        wbr, wbc = _row_ramp_up_np(row, ri), _row_ramp_up_np(col, ci)
    elif index == 3:  # overlap lower-left (ImageFusion.py:96-126)
        ri = select_first_nonzero(cand_top_down, True, True)
        ci = col_index_after(ri, True, False)
        wbr, wbc = _row_ramp_down_np(row, ri), _row_ramp_up_np(col, ci)
    elif index == 0:  # overlap lower-right (ImageFusion.py:128-158)
        ri = select_first_nonzero(cand_top_down, False, False)
        ci = col_index_after(ri, False, True)
        wbr, wbc = _row_ramp_down_np(row, ri), _row_ramp_down_np(col, ci)
    else:             # index == 1: overlap upper-right (ImageFusion.py:160-187)
        ri = select_first_nonzero(cand_bottom_up, False, False)
        ci = col_index_after(ri, False, True)
        wbr, wbc = _row_ramp_up_np(row, ri), _row_ramp_down_np(col, ci)
    return wbr, wbc


def corner_weight_vectors_np(image_a: np.ndarray, color: bool
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """getWeightsMatrix's separable factors: weightB = row_vec x col_vec
    (ImageFusion.py:43-190 builds wb1/wb2 as per-row / per-col ramps)."""
    a = np.asarray(image_a)
    row, col = a.shape[:2]
    valid = _valid_np(a, color)
    positive = a > 0
    quad = [
        int(np.count_nonzero(positive[0:row // 2, 0:col // 2])),
        int(np.count_nonzero(positive[row // 2:row, 0:col // 2])),
        int(np.count_nonzero(positive[row // 2:row, col // 2:col])),
        int(np.count_nonzero(positive[0:row // 2, col // 2:col])),
    ]
    any_col = valid.any(axis=0)
    last_v = np.where(any_col, (row - 1) - np.argmax(valid[::-1], axis=0), -1)
    first_v = np.where(any_col, np.argmax(valid, axis=0), -1)
    return corner_vectors_from_stats(quad, first_v, last_v,
                                     lambda ri: valid[ri], row, col)


def corner_fade_weights_np(image_a: np.ndarray, color: bool
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """getWeightsMatrix (ImageFusion.py:43-190), vectorized, float64.

    Mirrors weights.corner_fade_weights: the minimum-positive-count
    quadrant locates the overlap; boundary scans become argmax/argmin
    reductions; weightB = row_ramp x col_ramp, weightA = 1 - weightB.
    """
    wbr, wbc = corner_weight_vectors_np(image_a, color)
    wb = wbr[:, None] * wbc[None, :]
    return 1.0 - wb, wb


def _prefill_np(a: np.ndarray, b: np.ndarray):
    """Background elimination (Stitcher.py:498-504): -1 -> 0 then 0-fill."""
    a = np.where(a == -1, 0, a)
    b = np.where(b == -1, 0, b)
    a_f = np.where(a == 0, b, a)
    b_f = np.where(b == 0, a_f, b)
    return a_f, b_f


def _apply_weights_np(a: np.ndarray, b: np.ndarray, wa, wb, color: bool
                      ) -> np.ndarray:
    """A[A<0] <- B; float64 blend; clamp [0,255] (ImageFusion.py:240-243)."""
    if color:
        wa = wa[..., None]
        wb = wb[..., None]
    a = np.where(a < 0, b, a)
    res = wa * a.astype(np.float64) + wb * b.astype(np.float64)
    return np.clip(res, 0, 255).astype(np.uint8)


def _plain_fade_vectors(shape_hw, drow, dcol):
    """Linear cross-fade ramps (ImageFusion.py:213-235) as separable
    factors (war, wac, wbr, wbc): wa = war[i]*wac[j], wb = wbr[i]*wbc[j],
    float64."""
    row, col = shape_hw
    if col <= row:
        j = np.arange(col, dtype=np.float64)
        wa = (col - 1 - j) / col if dcol >= 0 else (j + 1) / col
        wb = j / col if dcol >= 0 else (col - j) / col
        ones = np.ones(row, np.float64)
        return ones, wa, ones, wb
    i = np.arange(row, dtype=np.float64)
    wa = i / row if drow <= 0 else (row - i) / row
    wb = (row - 1 - i) / row if drow <= 0 else (i + 1) / row
    ones = np.ones(col, np.float64)
    return wa, ones, wb, ones


def fuse_region_np(image_a: np.ndarray, image_b: np.ndarray,
                   drow: int, dcol: int, method: str, color: bool,
                   use_native: bool = True) -> np.ndarray:
    """Host float64 ``fuseImage`` dispatcher (Stitcher.py:488-525).

    ``image_a``/``image_b``: int regions with -1 sentinels.  The fade/trig
    weight matrices are separable row x col factor products, so the blend
    apply routes through the threaded C kernel
    (native/stitch_runtime.cpp isr_blend_rect, same float64 expressions)
    when available; numpy otherwise.  fade is bit-identical between the
    two; trig may differ by 1 LSB where numpy's SIMD sin and libm sin
    round differently (bounded in tests/test_host_blend.py).
    """
    if method in ("average", "maximum", "minimum", "notFuse"):
        a, b = _prefill_np(image_a, image_b)
        if method == "notFuse":
            return b.astype(np.uint8)
        if method == "average":
            return ((a + b) // 2).astype(np.uint8)
        if method == "maximum":
            return np.maximum(a, b).astype(np.uint8)
        return np.minimum(a, b).astype(np.uint8)
    row, col = image_a.shape[0], image_a.shape[1]
    valid_frac = np.count_nonzero(image_a > -1) / image_a.size
    if method not in ("fadeInAndFadeOut", "trigonometric"):
        raise ValueError(f"host fusion does not support: {method}")

    plain = valid_frac > 0.65
    if method == "fadeInAndFadeOut":
        if plain:
            war, wac, wbr, wbc = _plain_fade_vectors((row, col), drow, dcol)
            mode = 0
        else:
            wbr, wbc = corner_weight_vectors_np(image_a, color)
            war = wac = None
            mode = 1
    else:  # trigonometric — plain ramps mirror the fade ones
        if plain:
            if col <= row:
                j = np.arange(col, dtype=np.float64)
                base = j / col if dcol >= 0 else (col - j) / col
                war, wac = np.ones(row, np.float64), base
            else:
                i = np.arange(row, dtype=np.float64)
                base = i / row if drow <= 0 else (row - i) / row
                war, wac = base, np.ones(col, np.float64)
            wbr = wbc = None
            mode = 2
        else:
            wbr, wbc = corner_weight_vectors_np(image_a, color)
            war = wac = None
            mode = 3

    if use_native:
        from ...io import native_loader
        zr = np.zeros(row, np.float64)
        zc = np.zeros(col, np.float64)
        out = native_loader.blend_rect_native(
            image_a.astype(np.int16), image_b.astype(np.int16),
            war if war is not None else zr, wac if wac is not None else zc,
            wbr if wbr is not None else zr, wbc if wbc is not None else zc,
            mode)
        if out is not None:
            return out

    # numpy fallback: materialize the separable weights
    if mode == 0:
        wa = war[:, None] * wac[None, :]
        wb = wbr[:, None] * wbc[None, :]
    elif mode == 1:
        wb = wbr[:, None] * wbc[None, :]
        wa = 1.0 - wb
    elif mode == 2:
        wa = np.sin(war[:, None] * wac[None, :] * np.pi / 2.0) ** 2
        wb = 1.0 - wa
    else:
        wa = np.sin((1.0 - wbr[:, None] * wbc[None, :]) * np.pi / 2.0) ** 2
        wb = 1.0 - wa
    return _apply_weights_np(image_a, image_b, wa, wb, color)
