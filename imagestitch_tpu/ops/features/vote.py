"""Displacement voting: 2-D mode and translation RANSAC.

Exact batched semantics of the reference's registration decision rule
``getOffsetByMode`` (reference: ImageUtility.py:139-178):

  * per-match displacement (drow, dcol) = int-truncated keypoint difference
    (truncation toward zero, ImageUtility.py:160-161),
  * exact (0, 0) displacements are discarded (ImageUtility.py:158-159),
  * the 2-D mode wins, ties broken by FIRST OCCURRENCE in match order
    (dict-insertion-order semantics of ImageUtility.py:165-172),
  * success iff the modal count >= offset_evaluate (ImageUtility.py:175-176).

The unbounded Python count-dict becomes a sort + segmented run-length scheme
over fixed-capacity match slots: sort encoded keys, count runs with neighbor
compares, and pick the (count, first-occurrence) lexicographic winner.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

_OFF = 1 << 12          # supports |displacement| < 4096 (image edge < 4K px)
_SPAN = 1 << 13
_INVALID_BASE = _SPAN * _SPAN  # 2^26; + slot index stays well inside int32


@functools.partial(jax.jit, static_argnames=())
def _mode_vote_one(d_row: jnp.ndarray, d_col: jnp.ndarray, valid: jnp.ndarray
                   ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(K,) truncated displacements + validity -> (drow, dcol, count)."""
    k = d_row.shape[0]
    # reference discards exact (0,0) displacement pairs
    valid = valid & ~((d_row == 0) & (d_col == 0))
    valid = valid & (jnp.abs(d_row) < _OFF) & (jnp.abs(d_col) < _OFF)
    key = (d_row + _OFF) * _SPAN + (d_col + _OFF)
    # invalid slots get unique giant keys so they never form a run
    idx = jnp.arange(k, dtype=jnp.int32)
    key = jnp.where(valid, key, _INVALID_BASE + idx)
    order = jnp.argsort(key)
    skey = key[order]
    sidx = idx[order]                       # original positions, sorted by key
    # run starts
    start = jnp.concatenate([jnp.ones((1,), bool), skey[1:] != skey[:-1]])
    gid = jnp.cumsum(start.astype(jnp.int32)) - 1       # group id per slot
    counts = jnp.zeros((k,), jnp.int32).at[gid].add(jnp.ones_like(gid))
    first_occ = jnp.full((k,), k, jnp.int32).at[gid].min(sidx)
    group_key = jnp.zeros((k,), jnp.int32).at[gid].max(skey)
    # groups of invalid slots must lose: zero their counts
    counts = jnp.where(group_key < _INVALID_BASE, counts, 0)
    # lexicographic winner: max count, then min first occurrence
    score = counts * (k + 1) + (k - first_occ)
    win = jnp.argmax(score)
    wkey = group_key[win]
    drow = wkey // _SPAN - _OFF
    dcol = wkey % _SPAN - _OFF
    n = counts[win]
    any_valid = jnp.any(valid)
    # reference: empty displacement list -> single (0,0) vote (count 1).
    # ``any_valid`` is returned alongside so callers can tell this floor
    # apart from a GENUINE 1-vote mode (the two are indistinguishable from
    # ``n`` alone; conflating them mis-gates the oriented fallback).
    drow = jnp.where(any_valid, drow, 0)
    dcol = jnp.where(any_valid, dcol, 0)
    n = jnp.where(any_valid, n, 1)
    return drow, dcol, n, any_valid


@functools.partial(jax.jit, static_argnames=())
def _subpixel_refine_one(d_row, d_col, dr_f, dc_f, valid, mode_r, mode_c):
    """Sub-pixel offset: mean float displacement over the modal cluster.

    New capability for the global solver (the reference only ever emits
    integers): matches whose truncated displacement equals the winning mode
    vote with their un-truncated keypoint difference.
    """
    inl = valid & (d_row == mode_r) & (d_col == mode_c)
    cnt = jnp.maximum(jnp.sum(inl), 1)
    mr = jnp.sum(jnp.where(inl, dr_f, 0.0)) / cnt
    mc = jnp.sum(jnp.where(inl, dc_f, 0.0)) / cnt
    any_ = jnp.any(inl)
    return (jnp.where(any_, mr, mode_r.astype(jnp.float32)),
            jnp.where(any_, mc, mode_c.astype(jnp.float32)))


@jax.jit
def subpixel_refine_batch(d_row, d_col, dr_f, dc_f, valid, mode_r, mode_c):
    return jax.vmap(_subpixel_refine_one)(d_row, d_col, dr_f, dc_f, valid,
                                          mode_r, mode_c)


def displacement_from_matches(rows_a, cols_a, rows_b, cols_b,
                              train_idx, valid):
    """Truncated (drow, dcol) per match slot; A keypoint q vs B keypoint
    train_idx[q] (ImageUtility.py:153-161 coordinate-swap + int())."""
    rb = rows_b[train_idx]
    cb = cols_b[train_idx]
    d_row = (rows_a - rb).astype(jnp.int32)  # f32->s32 truncates toward zero
    d_col = (cols_a - cb).astype(jnp.int32)
    return d_row, d_col, valid


def displacement_from_matches_f(rows_a, cols_a, rows_b, cols_b, train_idx):
    """Un-truncated float displacements (sub-pixel refinement input)."""
    return rows_a - rows_b[train_idx], cols_a - cols_b[train_idx]


def displacement_from_coords(rows_a, cols_a, rb_sel, cb_sel, valid):
    """Displacements from PRE-EXTRACTED matched coordinates
    (match.match_batch_coords) — pure arithmetic, no per-match gathers."""
    d_row = (rows_a - rb_sel).astype(jnp.int32)
    d_col = (cols_a - cb_sel).astype(jnp.int32)
    return d_row, d_col, valid


@jax.jit
def mode_vote_batch(d_row: jnp.ndarray, d_col: jnp.ndarray,
                    valid: jnp.ndarray):
    """vmapped mode voting over the pair axis (P, K).

    Returns ``(drow, dcol, count, any_valid)`` — ``any_valid`` False means
    ``count`` is the reference's empty-displacement floor of 1, not a real
    single-vote consensus."""
    return jax.vmap(_mode_vote_one)(d_row, d_col, valid)


@functools.partial(jax.jit, static_argnames=("tol",))
def ransac_translation_batch(d_row: jnp.ndarray, d_col: jnp.ndarray,
                             valid: jnp.ndarray, tol: int = 3):
    """Translation-consensus alternative to the reference's RANSAC path.

    The reference estimates a full homography and keeps only its translation
    (ImageUtility.py:180-210, self-described as incomplete); for a
    translation-only rig the exact equivalent is consensus over per-match
    displacements: every match proposes its displacement, inliers are matches
    within ``tol`` (cv2.findHomography's reprojection threshold, =3), and the
    winner maximizes inlier count.  Returns (drow, dcol, inlier_count,
    any_valid); with no valid matches the count is 0 and any_valid False.
    """
    def one(dr, dc, v):
        drf = dr.astype(jnp.float32)
        dcf = dc.astype(jnp.float32)
        close = ((jnp.abs(drf[:, None] - drf[None, :]) <= tol) &
                 (jnp.abs(dcf[:, None] - dcf[None, :]) <= tol) &
                 v[None, :])
        counts = jnp.where(v, jnp.sum(close, axis=1), 0)
        win = jnp.argmax(counts)
        inl = close[win] & v
        n = counts[win]
        # refined estimate: rounded inlier mean (integer offset contract)
        mr = jnp.sum(jnp.where(inl, drf, 0.0)) / jnp.maximum(n, 1)
        mc = jnp.sum(jnp.where(inl, dcf, 0.0)) / jnp.maximum(n, 1)
        return (jnp.round(mr).astype(jnp.int32),
                jnp.round(mc).astype(jnp.int32), n, jnp.any(v))

    return jax.vmap(one)(d_row, d_col, valid)
