"""Batched descriptor matching as matrix products.

Batched replacement for the reference's brute-force matchers
(reference: ImageUtility.py:278-309 BruteForce kNN + Lowe ratio / Hamming;
CUDA analog appendix/myGpuFeatures.cpp:148-195).

The all-pairs L2 distance matrix is computed with the matmul identity
``|a-b|^2 = |a|^2 + |b|^2 - 2 a.b`` — one (K,D)x(D,K) contraction per pair
— and Hamming distance uses the same identity on {0,1} bit vectors
(``ham = |a| + |b| - 2 a.b``), so BOTH metric families are one GEMM each
instead of scalar XOR/popcount loops.

Top-2 selection is two masked row minima (cheaper than a general top-k).
All shapes fixed at capacity K; invalid slots are masked.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

# plain float: a module-level jnp scalar would initialize the JAX backend
# at import time, freezing the platform choice before callers can set it
_BIG = 3.4e38


def _pairwise_sq_l2(da: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """(Ka, D), (Kb, D) -> (Ka, Kb) squared L2 via one contraction.

    HIGHEST precision: descriptors are unit-norm, so |a|^2 + |b|^2 ~ 2 while
    good matches have d^2 << 1.  A TF32 product (10-bit mantissa, the GPU's
    default for f32 matmuls) errs by ~1e-3 in a.b — the size of the
    distances the 0.75 ratio test compares — and would flip matches.
    """
    ab = jnp.dot(da, db.T, preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST)
    na = jnp.sum(da * da, axis=-1, keepdims=True)
    nb = jnp.sum(db * db, axis=-1, keepdims=True)
    return jnp.maximum(na + nb.T - 2.0 * ab, 0.0)


def _pairwise_hamming(da: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """{0,1} float bit vectors -> Hamming distance via the matmul identity.

    Default precision is exact here: {0,1} operands are representable in
    TF32 and the products are summed in f32."""
    ab = jnp.dot(da, db.T, preferred_element_type=jnp.float32)
    na = jnp.sum(da, axis=-1, keepdims=True)
    nb = jnp.sum(db, axis=-1, keepdims=True)
    return na + nb.T - 2.0 * ab


def _top2_min(dist: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Row-wise two smallest: (d0, idx0, d1)."""
    d0 = jnp.min(dist, axis=-1)
    i0 = jnp.argmin(dist, axis=-1)
    masked = dist.at[jnp.arange(dist.shape[0]), i0].set(_BIG)
    d1 = jnp.min(masked, axis=-1)
    return d0, i0, d1


def match_ratio(da: jnp.ndarray, db: jnp.ndarray,
                valid_a: jnp.ndarray, valid_b: jnp.ndarray,
                ratio: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """kNN(2) + Lowe ratio on L2 (ImageUtility.py:287-296 semantics).

    Returns (train_idx, valid): for each query q in A, the matched index in B
    and whether the match survives (valid query, valid train, d0 < ratio*d1).
    Distances here are squared, so the test uses ratio^2 — equivalent for
    non-negative distances.
    """
    dist = _pairwise_sq_l2(da, db)
    dist = jnp.where(valid_b[None, :], dist, _BIG)
    d0, i0, d1 = _top2_min(dist)
    ok = valid_a & (d0 < (ratio * ratio) * d1) & (d1 < _BIG)
    return i0, ok


def match_nearest_hamming(da: jnp.ndarray, db: jnp.ndarray,
                          valid_a: jnp.ndarray, valid_b: jnp.ndarray,
                          max_distance: float = 1e9
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Plain nearest-neighbour Hamming match (ImageUtility.py:297-302: the
    CPU ORB path keeps every match; the GPU path thresholds by
    orbMaxDistance — exposed here via ``max_distance``)."""
    dist = _pairwise_hamming(da, db)
    dist = jnp.where(valid_b[None, :], dist, _BIG)
    d0 = jnp.min(dist, axis=-1)
    i0 = jnp.argmin(dist, axis=-1)
    ok = valid_a & (d0 <= max_distance) & (d0 < _BIG)
    return i0, ok


@functools.partial(jax.jit, static_argnames=("metric",))
def match_batch_coords(da: jnp.ndarray, db: jnp.ndarray,
                       valid_a: jnp.ndarray, valid_b: jnp.ndarray,
                       rows_b: jnp.ndarray, cols_b: jnp.ndarray,
                       ratio: float, max_distance: float,
                       metric: str = "l2"):
    """match_batch + matched train keypoint COORDINATES per query.

    Returns (train_idx, ok, rb_sel, cb_sel), each (P, K).
    """
    ti, ok = match_batch(da, db, valid_a, valid_b, ratio, max_distance,
                         metric)
    rb_sel = jnp.take_along_axis(rows_b, ti, axis=-1)
    cb_sel = jnp.take_along_axis(cols_b, ti, axis=-1)
    return ti, ok, rb_sel, cb_sel


@functools.partial(jax.jit, static_argnames=("metric",))
def match_batch(da: jnp.ndarray, db: jnp.ndarray,
                valid_a: jnp.ndarray, valid_b: jnp.ndarray,
                ratio: float, max_distance: float, metric: str = "l2"
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """vmap over the pair axis: (P, K, D) descriptors -> (P, K) matches."""
    if metric == "l2":
        f = lambda a, b, va, vb: match_ratio(a, b, va, vb, ratio)
    else:
        f = lambda a, b, va, vb: match_nearest_hamming(a, b, va, vb,
                                                       max_distance)
    return jax.vmap(f)(da, db, valid_a, valid_b)
