"""Search-strip (ROI) extraction for the incremental registration strategy.

Exact semantics of the reference's ``getROIRegionForIncreMethod``
(reference: ImageUtility.py:66-101): for direction ``d`` and search ratio
``s``, the "first" image contributes the strip facing the second image and
vice versa; strip length is ``floor(dim * s)``.

Static-shape discipline: the strip length depends only on the *static*
image shape and the *static* (direction, scale) attempt, so strip extraction
is a static slice — every attempt compiles to a fixed-shape kernel and a
whole pair-batch is sliced at once with one gather-free view.
"""
from __future__ import annotations

import math
from typing import Tuple

import jax.numpy as jnp


def strip_length(dim: int, search_ratio: float) -> int:
    """floor(dim * ratio) — ImageUtility.py:78 semantics."""
    return int(math.floor(dim * search_ratio))


def margin_correction(direction: int, shape_a: Tuple[int, int],
                      shape_b: Tuple[int, int], search_ratio: float) -> Tuple[int, int]:
    """Additive (drow, dcol) converting a strip-local offset to full-image.

    Exact semantics of reference Stitcher.py:352-361 (feature path) and
    :243-253 (phase path): the margin uses ``int(ratio * dim)`` truncation.
    """
    ra, ca = shape_a
    rb, cb = shape_b
    if direction == 1:
        return ra - int(search_ratio * ra), 0
    if direction == 2:
        return 0, ca - int(search_ratio * ca)
    if direction == 3:
        return -(rb - int(search_ratio * rb)), 0
    if direction == 4:
        return 0, -(cb - int(search_ratio * cb))
    raise ValueError(f"bad direction {direction}")


def extract_strips(images_a: jnp.ndarray, images_b: jnp.ndarray,
                   direction: int, search_ratio: float
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Slice the facing strips out of batched pairs.

    images_a/images_b: ``(P, H, W)`` batches (P pairs).  Returns
    ``(roi_a, roi_b)`` with identical static shapes per (direction, ratio).

    Direction table (ImageUtility.py:77-100):
      1: A bottom strip  / B top strip
      2: A right strip   / B left strip
      3: A top strip     / B bottom strip
      4: A left strip    / B right strip
    """
    h, w = images_a.shape[-2], images_a.shape[-1]
    if direction in (1, 3):
        L = strip_length(h, search_ratio)
        if direction == 1:
            return images_a[..., h - L:h, :], images_b[..., 0:L, :]
        return images_a[..., 0:L, :], images_b[..., h - L:h, :]
    elif direction in (2, 4):
        L = strip_length(w, search_ratio)
        if direction == 2:
            return images_a[..., :, w - L:w], images_b[..., :, 0:L]
        return images_a[..., :, 0:L], images_b[..., :, w - L:w]
    raise ValueError(f"bad direction {direction}")


def extract_fixed_strips(images_a: jnp.ndarray, images_b: jnp.ndarray,
                         direction, search_length: int,
                         search_length_large: int = -1):
    """Fixed-pixel-length ROI variant (deprecated in the reference but part
    of its API surface: ``getROIRegion``, ImageUtility.py:103-137).

    ``direction`` accepts "horizontal"/2 or "vertical"/1;
    ``search_length_large`` additionally crops the cross axis when > 0.
    """
    h, w = images_a.shape[-2], images_a.shape[-1]
    L = search_length
    XL = search_length_large
    if direction in ("horizontal", 2):
        a = images_a[..., :, w - L:w]
        b = images_b[..., :, 0:L]
        if XL > 0:
            a = a[..., h - XL:h, :]
            b = b[..., 0:XL, :]
        return a, b
    if direction in ("vertical", 1):
        a = images_a[..., h - L:h, :]
        b = images_b[..., 0:L, :]
        if XL > 0:
            a = a[..., :, w - XL:w]
            b = b[..., :, 0:XL]
        return a, b
    raise ValueError(f"bad direction {direction}")
