"""Homography RANSAC offset estimation (reference ImageUtility.py:180-210).

The reference's ``getOffsetByRansac`` runs
``cv2.findHomography(ptsA, ptsB, cv2.RANSAC, 3)``, counts the inlier mask,
succeeds when inliers >= offsetEvaluate, and returns the NEGATED, int-
truncated translation column of H:
``[dx, dy] = [-int(H[1,2]), -int(H[0,2])]`` plus an ``adjustH`` copy of H
with the translation and projective terms zeroed (ImageUtility.py:203-208).

Batched re-design (everything batched over the pair axis, static
shapes, no host round trips):

  * hypotheses: ``N_ITERS`` random 4-match minimal samples per pair, drawn
    with a counter-based deterministic PRNG (same seed -> same result; the
    sequential adaptive-iteration loop of cv2 becomes a fixed-width batch,
    sized by the standard RANSAC bound: 128 > log(1-0.995)/log(1-w^4) for
    inlier ratios w >= 0.45);
  * each sample solves the exact-DLT 8x8 system (h33=1) for its
    homography — batched ``jnp.linalg.solve`` over (P, N_ITERS, 8, 8);
  * scoring: squared reprojection error <= tol^2 (cv2's RANSAC inlier
    rule), masked to valid matches; degenerate samples (singular systems
    -> non-finite H) score zero;
  * the winning hypothesis's inliers get a least-squares DLT refit
    (Hartley-normalized 9x9 normal equations + eigh null vector), the
    analog of cv2's final refinement on the consensus set.

cv2 parity is semantic, not bit-exact (cv2's sampling order is its own
RNG); the oracle test (tests/test_ransac.py) asserts equal integer offsets
and matching accept decisions on outlier-laden synthetic data.

Faithful-quirk note: unlike ``getOffsetByMode`` (which discards exact
(0,0) displacements, ImageUtility.py:158-159), the reference's RANSAC path
feeds ALL matches to findHomography — on whole-image micrograph pairs
whose spurious self-similar matches form a near-identity cluster, both cv2
and this implementation lock onto that cluster (verified on zirconBSE:
cv2 returns (-11,-11) with 279 "inliers" where the true offset is
(-32,-1128)).  This is why the reference marks the path 不完善/incomplete
(ImageUtility.py:186) and its driver always uses mode voting; ours
reproduces the estimator, not a repaired version of it.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

#: fixed hypothesis count (see module docstring for the sizing bound)
N_ITERS = 128
#: deterministic sampling seed (frozen-config determinism, SURVEY §5)
_SEED = 0x5713


def _dlt_exact(px: jnp.ndarray, py: jnp.ndarray,
               qx: jnp.ndarray, qy: jnp.ndarray) -> jnp.ndarray:
    """Exact homography from 4 correspondences (p -> q), h33 = 1.

    Rows of the 8x8 system per correspondence (x, y) -> (u, v):
      [x y 1 0 0 0 -ux -uy] . h = u
      [0 0 0 x y 1 -vx -vy] . h = v
    Returns the 3x3 H (non-finite entries when the sample is degenerate).
    """
    zeros = jnp.zeros_like(px)
    ones = jnp.ones_like(px)
    rows_u = jnp.stack([px, py, ones, zeros, zeros, zeros,
                        -qx * px, -qx * py], axis=-1)
    rows_v = jnp.stack([zeros, zeros, zeros, px, py, ones,
                        -qy * px, -qy * py], axis=-1)
    a = jnp.concatenate([rows_u, rows_v], axis=-2)          # (8, 8)
    b = jnp.concatenate([qx, qy], axis=-1)[..., None]       # (8, 1)
    h = jnp.linalg.solve(a, b)[..., 0]
    return jnp.concatenate([h, jnp.ones_like(h[..., :1])], -1).reshape(3, 3)


def _project(h: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray):
    """Apply a 3x3 homography to (x, y) point arrays."""
    w = h[2, 0] * x + h[2, 1] * y + h[2, 2]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    u = (h[0, 0] * x + h[0, 1] * y + h[0, 2]) / w
    v = (h[1, 0] * x + h[1, 1] * y + h[1, 2]) / w
    return u, v


def _refit_dlt(px, py, qx, qy, weight) -> jnp.ndarray:
    """Weighted least-squares DLT over the consensus set.

    Hartley normalization (zero-mean, sqrt(2) RMS) on both sides, then the
    smallest eigenvector of the 9x9 normal matrix A^T A.
    """
    def norm(x, y, w):
        nw = jnp.maximum(jnp.sum(w), 1.0)
        mx = jnp.sum(x * w) / nw
        my = jnp.sum(y * w) / nw
        d = jnp.sqrt((x - mx) ** 2 + (y - my) ** 2)
        s = jnp.sqrt(2.0) / jnp.maximum(jnp.sum(d * w) / nw, 1e-9)
        t = jnp.array([[s, 0.0, -s * mx], [0.0, s, -s * my],
                       [0.0, 0.0, 1.0]])
        return (x - mx) * s, (y - my) * s, t

    pxn, pyn, tp = norm(px, py, weight)
    qxn, qyn, tq = norm(qx, qy, weight)
    zeros = jnp.zeros_like(pxn)
    ones = jnp.ones_like(pxn)
    ru = jnp.stack([pxn, pyn, ones, zeros, zeros, zeros,
                    -qxn * pxn, -qxn * pyn, -qxn], axis=-1)
    rv = jnp.stack([zeros, zeros, zeros, pxn, pyn, ones,
                    -qyn * pxn, -qyn * pyn, -qyn], axis=-1)
    a = jnp.concatenate([ru * weight[..., None], rv * weight[..., None]],
                        axis=0)                              # (2K, 9)
    # HIGHEST precision: the smallest eigenvector of A^T A is the DLT
    # solution, and TF32 products (10-bit mantissa, the GPU's default for
    # f32 matmuls) perturb it enough to move the truncated translation.
    hi = jax.lax.Precision.HIGHEST
    ata = jnp.matmul(a.T, a, precision=hi)
    _, vecs = jnp.linalg.eigh(ata)
    h = vecs[:, 0].reshape(3, 3)                             # smallest eig
    h_full = jnp.linalg.solve(tq, jnp.matmul(h, tp, precision=hi))
    scale = jnp.where(jnp.abs(h_full[2, 2]) < 1e-12, 1e-12, h_full[2, 2])
    return h_full / scale


def _ransac_one(px, py, qx, qy, valid, tol_sq: float, n_iters: int,
                key: jnp.ndarray):
    """Single-pair homography RANSAC.  Returns (tx, ty, n_inliers, ok_any).

    (tx, ty) is the translation column of the refit H (p -> q frame).
    """
    k = px.shape[0]
    n_valid = jnp.sum(valid)
    # sample 4 distinct valid indices per hypothesis: random keys, invalid
    # slots pushed to the bottom, top-4 distinct by construction
    keys = jax.random.uniform(key, (n_iters, k))
    keys = jnp.where(valid[None, :], keys, -1.0)
    _, idx = jax.lax.top_k(keys, 4)                          # (n_iters, 4)

    def score(h):
        u, v = _project(h, px, py)
        err = (u - qx) ** 2 + (v - qy) ** 2
        finite = jnp.all(jnp.isfinite(h))
        inl = valid & (err <= tol_sq) & finite
        return jnp.sum(inl)

    def one_hyp(sample_idx):
        h = _dlt_exact(px[sample_idx], py[sample_idx],
                       qx[sample_idx], qy[sample_idx])
        return score(h), h

    counts, hs = jax.vmap(one_hyp)(idx)
    best = jnp.argmax(counts)
    h_best = hs[best]
    # iterated consensus refit (cv2's post-RANSAC LM-refinement analog):
    # refit on the inlier set, re-gate inliers with the refit model, refit
    # again — two rounds converge on translation-dominant data.  The refit
    # is always used when finite (cv2 reports the refined H, never the raw
    # 4-point model).
    h_fin = h_best
    inl = jnp.zeros_like(valid)
    for _ in range(2):
        u, v = _project(h_fin, px, py)
        err = (u - qx) ** 2 + (v - qy) ** 2
        inl = valid & (err <= tol_sq) & jnp.all(jnp.isfinite(h_fin))
        h_ref = _refit_dlt(px, py, qx, qy, inl.astype(jnp.float32))
        h_fin = jnp.where(jnp.all(jnp.isfinite(h_ref)), h_ref, h_fin)
    u, v = _project(h_fin, px, py)
    err = (u - qx) ** 2 + (v - qy) ** 2
    inl = valid & (err <= tol_sq) & jnp.all(jnp.isfinite(h_fin))
    n_fin = jnp.where(n_valid >= 4, jnp.sum(inl), 0)
    return h_fin[0, 2], h_fin[1, 2], n_fin, n_fin > 0


@functools.partial(jax.jit, static_argnames=("tol", "n_iters"))
def ransac_homography_batch(rows_a: jnp.ndarray, cols_a: jnp.ndarray,
                            rows_b: jnp.ndarray, cols_b: jnp.ndarray,
                            valid: jnp.ndarray, tol: float = 3.0,
                            n_iters: int = N_ITERS):
    """Batched reference-semantics RANSAC offset (pair axis leading).

    Inputs are matched keypoint coordinates in (row, col) = (y, x) frame,
    shape (P, K) + validity.  Returns ``(drow, dcol, n_inliers, any_valid,
    srow, scol)``: int-truncated offsets per ImageUtility.py:203-207
    (``-int(H[1,2])``, ``-int(H[0,2])``), the inlier count, whether a model
    could be estimated, and the float (sub-pixel) offsets for the solver.
    """
    keys = jax.random.split(jax.random.PRNGKey(_SEED), rows_a.shape[0])

    def one(ra, ca, rb, cb, v, key):
        # cv2 frame: x = col, y = row; H maps A -> B
        tx, ty, n, ok = _ransac_one(ca, ra, cb, rb, v, float(tol) ** 2,
                                    n_iters, key)
        # reference: [dx, dy] = [-int(H[1,2]), -int(H[0,2])] (truncation)
        drow = -ty.astype(jnp.int32)
        dcol = -tx.astype(jnp.int32)
        return drow, dcol, n, ok, -ty, -tx

    return jax.vmap(one)(rows_a, cols_a, rows_b, cols_b, valid, keys)
