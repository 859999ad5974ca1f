"""Optimal-seam-line fusion.

Batched replacement for the reference's seam suite
(reference: ImageFusion.py:377-492): the per-pixel Python energy loop becomes
vectorized ops, the row-by-row DP becomes a ``lax.scan`` with a vectorized
3-neighbor transition, and the backtrack is a second scan.  The reference's
blocking cv2.imshow/imwrite debug calls are dropped (debug overlay available
as ``draw_seam_overlay``).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_SX = np.array([[-2, 0, 2], [-1, 0, 1], [-2, 0, 2]], np.float32)
_SY = np.array([[-2, -1, -2], [0, 0, 0], [2, 1, 2]], np.float32)
_INFINITE = 10000.0
_W = 10.0


def _correlate2d_reflect(x: jnp.ndarray, k: np.ndarray) -> jnp.ndarray:
    """cv2.filter2D semantics: correlation, reflect-101 border, same size."""
    kh, kw = k.shape
    ph, pw = kh // 2, kw // 2
    xp = jnp.pad(x, ((ph, ph), (pw, pw)), mode="reflect")
    out = jnp.zeros_like(x)
    for i in range(kh):
        for j in range(kw):
            if k[i, j] != 0.0:
                out = out + k[i, j] * xp[i:i + x.shape[0], j:j + x.shape[1]]
    return out


def seam_energy(image_a: jnp.ndarray, image_b: jnp.ndarray) -> jnp.ndarray:
    """caculateVaule (ImageFusion.py:403-428), vectorized.

    energy = scaled-difference weight x (E_color^2 + E_geometry) with the
    modified Sobel kernels; pixels whose normalized difference exceeds
    0.7*max get the 'infinite' wall weight.
    """
    a = image_a.astype(jnp.float32)
    b = image_b.astype(jnp.float32)
    e_color = a - b
    e_geometry = _correlate2d_reflect(e_color, _SX) ** 2 + \
        _correlate2d_reflect(e_color, _SY) ** 2
    denom = jnp.max(jnp.maximum(a, b))
    diff = jnp.abs(a - b) / denom
    diff_max = jnp.max(diff)
    w = jnp.where(diff < 0.7 * diff_max, _W * diff / diff_max, _INFINITE)
    return w * (e_color ** 2 + e_geometry)


def find_optimal_seam(value: jnp.ndarray, direction="horizontal"
                      ) -> jnp.ndarray:
    """findOptimalSeamLine (ImageFusion.py:430-475) as two scans.

    Returns the uint8 mask (1 right of the seam) with the reference's exact
    conventions: top row of the DP seeds with the energy row, transitions are
    3-neighbor with leftmost tie-break, mask row 0 is never written, and the
    backtrack stops at row 1 (ImageFusion.py:466-472).

    ``direction``: only the string "vertical" transposes; the reference's
    dispatcher actually passes an int (Stitcher.py:524 passes self.direction),
    so in practice the horizontal path always runs — parity preserved.
    """
    if direction == "vertical":
        value = value.T
    rows, cols = value.shape

    inf_sentinel = jnp.asarray(jnp.inf, value.dtype)

    def dp_step(prev, row_vals):
        left = jnp.concatenate([jnp.full((1,), inf_sentinel, value.dtype), prev[:-1]])
        right = jnp.concatenate([prev[1:], jnp.full((1,), inf_sentinel, value.dtype)])
        # candidate order LEFT, MID, RIGHT with leftmost tie-break (np.argmin)
        stack = jnp.stack([left, prev, right])          # (3, cols)
        amin = jnp.argmin(stack, axis=0)                 # 0=left,1=mid,2=right
        best = jnp.min(stack, axis=0)
        move = amin.astype(jnp.int32) - 1                # -1 / 0 / +1
        # edge semantics (ImageFusion.py:448-457): j==0 chooses between
        # mid(0)/right(+1); j==cols-1 between left(-1)/mid(0) — covered by the
        # +-inf sentinels, but tie-break differs at j==0: ref argmin([mid,
        # right]) prefers MID on ties, ours prefers LEFT=inf (never) then MID.
        dp = best + row_vals
        return dp, move

    dp0 = value[0]
    dp_last, moves = jax.lax.scan(dp_step, dp0, value[1:])  # moves: (rows-1, cols)

    start = jnp.argmin(dp_last).astype(jnp.int32)

    col_iota = jnp.arange(cols)

    def backtrack(idx, move_row):
        mask_row = (col_iota >= idx).astype(jnp.uint8)
        new_idx = jnp.clip(idx + move_row[idx], 0, cols - 1)
        return new_idx, mask_row

    # reference backtrack: mask[row-1, index:]=1; then for i in
    # [row-1 .. 2]: index += indexMatrix[i, index]; mask[i-1, index:]=1.
    # moves[i-1] corresponds to indexMatrix row i.
    mask = jnp.zeros((rows, cols), jnp.uint8)
    mask = mask.at[rows - 1].set((col_iota >= start).astype(jnp.uint8))
    idx = start
    if rows > 2:
        move_seq = moves[::-1][: rows - 2]   # rows row-1 .. 2 of indexMatrix
        idx, mask_rows = jax.lax.scan(backtrack, idx, move_seq)
        mask = mask.at[1:rows - 1].set(mask_rows[::-1])
    if direction == "vertical":
        mask = mask.T
    return mask


@jax.jit
def fuse_optimal_seam(image_a: jnp.ndarray, image_b: jnp.ndarray) -> jnp.ndarray:
    """fuseByOptimalSeamLine (ImageFusion.py:377-401): seam mask + masked
    multi-band blend.  Inputs are int32 regions with -1 sentinels."""
    from .blend import _prefill_background
    from .pyramid import blend_masked
    a, b = _prefill_background(image_a, image_b)
    value = seam_energy(a, b)
    mask = 1 - find_optimal_seam(value)
    out = blend_masked(a.astype(jnp.float32), b.astype(jnp.float32),
                       mask.astype(jnp.float32), 4)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def draw_seam_overlay(mask: np.ndarray, fuse_region: np.ndarray) -> np.ndarray:
    """Non-blocking analog of drawOptimalLine (ImageFusion.py:477-492):
    first seam pixel per column painted red on a BGR copy."""
    mask = np.asarray(mask)
    gray = np.asarray(fuse_region)
    out = np.stack([gray, gray, gray], axis=-1).astype(np.uint8)
    first = np.argmax(mask == 1, axis=0)
    has = (mask == 1).any(axis=0)
    for j in np.nonzero(has)[0]:
        out[first[j], j] = (0, 0, 255)
    return out
