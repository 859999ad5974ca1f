"""Gaussian/Laplacian pyramids and multi-band blending.

Batched conv/resize chains replacing the reference's cv2 pyramid engine
(reference: ImageFusion.py:296-374).  pyrDown/pyrUp use the classic 5-tap
binomial kernel with reflect-101 borders, matching cv2 away from a 2-pixel
border band (cv2's pyrUp border scheme differs slightly; validated in tests).

The reference's Laplacian construction has an off-by-one quirk — the list is
seeded with gp[level-1] and its final (i==0) entry indexes gp[-1]
(ImageFusion.py:343-351) — but its consumers only read the first ``level``
entries (ImageFusion.py:323-327, :337-339), so the effective scheme is a
standard blend with base gp[level-1]; that effective scheme is what we build.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_K5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _sep_conv_reflect(x: jnp.ndarray, k: np.ndarray) -> jnp.ndarray:
    """Separable 2-D correlation with reflect-101 padding on (H, W) float."""
    pad = len(k) // 2
    xp = jnp.pad(x, ((pad, pad), (0, 0)), mode="reflect")
    kcol = jnp.asarray(k, x.dtype)
    # correlate along rows (axis 0)
    x0 = sum(xp[i:i + x.shape[0], :] * kcol[i] for i in range(len(k)))
    xp = jnp.pad(x0, ((0, 0), (pad, pad)), mode="reflect")
    x1 = sum(xp[:, i:i + x.shape[1]] * kcol[i] for i in range(len(k)))
    return x1


def pyr_down(x: jnp.ndarray) -> jnp.ndarray:
    """cv2.pyrDown semantics: blur then decimate; out dims (n+1)//2."""
    return _sep_conv_reflect(x, _K5)[::2, ::2]


def pyr_up(x: jnp.ndarray) -> jnp.ndarray:
    """cv2.pyrUp semantics: zero-stuff to 2x then blur with the 4x kernel."""
    h, w = x.shape
    up = jnp.zeros((2 * h, 2 * w), x.dtype).at[::2, ::2].set(x)
    # total gain 4 to conserve brightness: 2x per separable axis
    return _sep_conv_reflect(up, _K5 * 2.0)


def _resize_to(x: jnp.ndarray, shape_hw: Tuple[int, int]) -> jnp.ndarray:
    """cv2.resize INTER_CUBIC analog (half-pixel-centered Keys cubic)."""
    if x.shape == tuple(shape_hw):
        return x
    return jax.image.resize(x, shape_hw, method="cubic")


def gaussian_pyramid(x: jnp.ndarray, level: int) -> List[jnp.ndarray]:
    """gp[0]=x, gp[k+1]=pyrDown(gp[k]); level+1 entries (ImageFusion.py:361-367)."""
    gp = [x.astype(jnp.float32)]
    for _ in range(level):
        gp.append(pyr_down(gp[-1]))
    return gp


def laplacian_pyramid(x: jnp.ndarray, level: int
                      ) -> Tuple[List[jnp.ndarray], List[jnp.ndarray]]:
    """Effective reference Laplacian stack (see module docstring).

    Returns (lp, gp) where lp[0] = gp[level-1] and
    lp[k] = gp[level-1-k] - resize(pyrUp(gp[level-k])) for k >= 1 —
    exactly the ``level`` entries the reference's consumers read.
    """
    gp = gaussian_pyramid(x, level)
    lp = [gp[level - 1]]
    for i in range(level - 1, 0, -1):
        ge = _resize_to(pyr_up(gp[i]), gp[i - 1].shape)
        lp.append(gp[i - 1] - ge)
    return lp, gp


def reconstruct(lp: List[jnp.ndarray]) -> jnp.ndarray:
    """pyrUp + add chain (ImageFusion.py:353-359)."""
    out = lp[0]
    for i in range(1, len(lp)):
        out = _resize_to(pyr_up(out), lp[i].shape) + lp[i]
    return out


def blend_half(a: jnp.ndarray, b: jnp.ndarray, level: int = 4) -> jnp.ndarray:
    """BlendArbitrary2: 0.5/0.5 per-level blend (ImageFusion.py:331-341)."""
    la, _ = laplacian_pyramid(a, level)
    lb, _ = laplacian_pyramid(b, level)
    lc = [0.5 * x + 0.5 * y for x, y in zip(la, lb)]
    return reconstruct(lc)


def blend_masked(a: jnp.ndarray, b: jnp.ndarray, region: jnp.ndarray,
                 level: int = 4) -> jnp.ndarray:
    """BlendArbitrary: region-weighted blend (ImageFusion.py:306-329).

    ``region`` weights image a; (1 - region) weights image b.  The reference
    pairs lp[i] (fine->coarse? — lp[0] is the coarsest base) with
    GR[level-1-i], i.e. the mask pyramid level of MATCHING resolution.
    """
    la, _ = laplacian_pyramid(a, level)
    lb, _ = laplacian_pyramid(b, level)
    gr = gaussian_pyramid(region.astype(jnp.float32), level)
    lc = []
    for i in range(level):
        m = gr[level - 1 - i]
        lc.append(la[i] * m + lb[i] * (1.0 - m))
    return reconstruct(lc)


@jax.jit
def fuse_multiband(image_a: jnp.ndarray, image_b: jnp.ndarray) -> jnp.ndarray:
    """fuseByMultiBandBlending (ImageFusion.py:296-304): gray regions with the
    dispatcher's background prefill already applied by the caller via
    blend._prefill_background."""
    from .blend import _prefill_background
    a, b = _prefill_background(image_a, image_b)
    out = blend_half(a.astype(jnp.float32), b.astype(jnp.float32), 4)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)
