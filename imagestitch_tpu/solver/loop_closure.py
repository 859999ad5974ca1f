"""Grid loop-closure edges for the pose-graph solver.

The reference chains pairwise offsets by prefix sum, so serpentine-grid
drift is unbounded (reference: Stitcher.py:404-405 — SURVEY §2.3 calls this
its biggest weakness).  On a grid, non-consecutive tiles overlap too (a
tile overlaps the tile directly above it in the previous row); measuring
those overlaps and adding them as extra pose-graph edges closes the loops
and pins the drift.

Pipeline:
  1. ``propose_edges`` — from the chain-estimated positions, every
     non-adjacent tile pair whose predicted overlap exceeds a fraction of
     the tile area becomes a candidate;
  2. ``verify_edges`` — each candidate is measured by phase correlation on
     fixed-size windows around the predicted overlap (one batched device
     dispatch; windows make this ~20x cheaper than whole-tile FFTs), and
     candidates whose response clears the threshold become weighted edges;
  3. the solver (solver/pose_graph.py) runs weighted least squares over the
     chain + loop edges.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import phase_corr


def propose_edges(positions: np.ndarray, image_shape: Tuple[int, int],
                  min_overlap_frac: float = 0.04,
                  max_candidates: int = 512) -> List[Tuple[int, int]]:
    """Candidate (i, j) tile pairs (j > i + 1) whose chain-predicted overlap
    area exceeds ``min_overlap_frac`` of the tile area.

    Spatial-hash candidate generation: tiles are bucketed
    into an (h, w) cell grid by predicted position; two tiles can only
    overlap if their cells are identical or adjacent, so each tile is tested
    against its 3x3 cell neighborhood — O(n * density) instead of the O(n^2)
    double loop (which at the 1000-tile stretch config is 500k pair tests
    for ~2k real candidates).
    """
    h, w = image_shape
    pos = np.asarray(positions, np.float64)
    n = len(pos)
    cells: dict = {}
    for i in range(n):
        cells.setdefault((int(pos[i, 0] // h), int(pos[i, 1] // w)),
                         []).append(i)
    cands = []
    for (cr, cc), members in cells.items():
        neigh: List[int] = []
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                neigh.extend(cells.get((cr + dr, cc + dc), ()))
        for i in members:
            for j in neigh:
                if j <= i + 1:      # adjacent pairs are chain edges already
                    continue
                drow = pos[j, 0] - pos[i, 0]
                dcol = pos[j, 1] - pos[i, 1]
                ov_r = h - abs(drow)
                ov_c = w - abs(dcol)
                if ov_r <= 0 or ov_c <= 0:
                    continue
                frac = (ov_r * ov_c) / (h * w)
                if frac >= min_overlap_frac:
                    cands.append((frac, i, j))
    cands.sort(reverse=True)
    return [(i, j) for _, i, j in cands[:max_candidates]]


@functools.partial(jax.jit, static_argnames=("win_h", "win_w", "hp", "wp"))
def _verify_windows_jit(images: jnp.ndarray, ia: jnp.ndarray, ib: jnp.ndarray,
                        sa: jnp.ndarray, sb: jnp.ndarray,
                        win_h: int, win_w: int, hp: int, wp: int):
    """Phase-correlate per-edge windows: tile ia's window at sa vs tile ib's
    window at sb.  One dispatch for the whole candidate batch."""
    def one(a_idx, b_idx, s_a, s_b):
        wa = jax.lax.dynamic_slice(images[a_idx], (s_a[0], s_a[1]),
                                   (win_h, win_w)).astype(jnp.float32)
        wb = jax.lax.dynamic_slice(images[b_idx], (s_b[0], s_b[1]),
                                   (win_h, win_w)).astype(jnp.float32)
        wa = wa - jnp.mean(wa)
        wb = wb - jnp.mean(wb)
        sx, sy, resp = phase_corr._phase_correlate_one(wa, wb, hp, wp)
        # renormalize the response from padded to true window area
        return sx, sy, resp * (float(hp) * wp / (win_h * win_w))

    return jax.vmap(one)(ia, ib, sa, sb)


def verify_edges(images: np.ndarray, positions: np.ndarray,
                 edges: Sequence[Tuple[int, int]],
                 pad: int = 64, response_threshold: float = 0.05,
                 max_window: int = 512
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Measure candidate edges by windowed phase correlation.

    Returns (edges_a, edges_b, measurements, weights) for candidates whose
    phase response clears ``response_threshold`` (weights = response).
    The chain positions only LOCATE the windows (drift << pad); the
    measured offset is independent of the prior's error.

    ``max_window`` caps each window dimension: measuring a translation
    needs a well-textured patch plus drift margin, NOT the whole overlap —
    at full-resolution tiles an uncapped window is a (2000, 2584) FFT per
    candidate (the r4 real-size stretch spent 155 s verifying 675 edges).
    Capped windows center on the predicted overlap for texture.
    """
    if not edges:
        z = np.zeros(0)
        return z.astype(np.int32), z.astype(np.int32), z.reshape(0, 2), z
    n, h, w = images.shape
    pos = np.round(np.asarray(positions, np.float64)).astype(np.int64)
    d0 = np.stack([pos[j] - pos[i] for i, j in edges])   # (E, 2) prior offset
    e = len(edges)
    # BUCKETED window sizes: one global max-size window
    # made every candidate pay the worst case (the 1024-tile stretch spent
    # 3.1 s verifying vs 0.5 s solving).  Per-edge ideal size = predicted
    # overlap + 2*pad capped at ``max_window``, rounded UP to a 128-px
    # bucket edge (compile-bounded shape set, same scheme as the composer's
    # rect buckets); one batched dispatch per bucket.
    ideal = np.stack([
        np.clip(np.maximum(h - np.abs(d0[:, 0]) + 2 * pad, 2 * pad),
                0, min(h, max_window)),
        np.clip(np.maximum(w - np.abs(d0[:, 1]) + 2 * pad, 2 * pad),
                0, min(w, max_window)),
    ], axis=1).astype(np.int64)
    bucket = np.stack([np.minimum(-(-ideal[:, 0] // 128) * 128, h),
                       np.minimum(-(-ideal[:, 1] // 128) * 128, w)], axis=1)
    ia_all = np.asarray([i for i, _ in edges], np.int32)
    ib_all = np.asarray([j for _, j in edges], np.int32)
    sx = np.zeros(e)
    sy = np.zeros(e)
    resp = np.zeros(e)
    meas = np.zeros((e, 2))
    images_dev = jnp.asarray(images)
    for bh, bw in sorted({(int(r), int(c)) for r, c in bucket}):
        sel = np.nonzero((bucket[:, 0] == bh) & (bucket[:, 1] == bw))[0]
        win_h, win_w = int(bh), int(bw)
        sa = np.zeros((len(sel), 2), np.int32)
        sb = np.zeros((len(sel), 2), np.int32)
        for kk, k in enumerate(sel):
            for ax, dim, wl in ((0, h, win_h), (1, w, win_w)):
                # center the (possibly capped) window within the predicted
                # overlap; the measurement sa - sb - (window shift) is exact
                # for any anchor, centering just maximizes shared texture
                ov_start = max(int(d0[k, ax]), 0)
                ov_len = dim - abs(int(d0[k, ax]))
                a0 = int(np.clip(ov_start + max(ov_len - wl, 0) // 2 - pad,
                                 0, dim - wl))
                b0 = int(np.clip(a0 - d0[k, ax], 0, dim - wl))
                sa[kk, ax] = a0
                sb[kk, ax] = b0
        # 2x padding = full linear correlation: window anchor clipping can
        # make the inter-window shift approach the window size, which a
        # circularly padded correlation would alias (same repair as the
        # whole-image phase path, core/registration.py)
        hp = phase_corr.optimal_dft_size(2 * win_h)
        wp = phase_corr.optimal_dft_size(2 * win_w)
        # chunk the batch by padded-FFT working set: full-resolution tiles
        # make per-edge temporaries ~100 MB; vmapping a thousand edges at
        # once demands tens of GB (measured OOM on the real-size stretch)
        per_edge = 6 * hp * wp * 8
        chunk = max(1, (2 << 30) // per_edge)
        gxl, gyl, grl = [], [], []
        for cs in range(0, len(sel), chunk):
            ce = sel[cs:cs + chunk]
            cx, cy, cr = _verify_windows_jit(
                images_dev, jnp.asarray(ia_all[ce]), jnp.asarray(ib_all[ce]),
                jnp.asarray(sa[cs:cs + chunk]), jnp.asarray(sb[cs:cs + chunk]),
                win_h, win_w, hp, wp)
            gxl.append(np.asarray(cx))
            gyl.append(np.asarray(cy))
            grl.append(np.asarray(cr))
        gx = np.concatenate(gxl)
        gy = np.concatenate(gyl)
        gr = np.concatenate(grl)
        sx[sel], sy[sel], resp[sel] = gx, gy, gr
        # cv2-style (x, y) is minus the displacement: window offset =
        # (-y, -x); full measurement = anchor delta + measured window offset
        meas[sel, 0] = sa[:, 0] - sb[:, 0] - gy
        meas[sel, 1] = sa[:, 1] - sb[:, 1] - gx
    keep = resp > response_threshold
    return (ia_all[keep], ib_all[keep], meas[keep].astype(np.float32),
            resp[keep].astype(np.float32))


def close_loops(images: np.ndarray, graph, positions: np.ndarray,
                image_shape: Tuple[int, int],
                min_overlap_frac: float = 0.04,
                response_threshold: float = 0.05):
    """Chain graph + verified loop edges.  Returns (graph, n_edges_added)."""
    cands = propose_edges(positions, image_shape, min_overlap_frac)
    ia, ib, meas, wgt = verify_edges(images, positions, cands,
                                     response_threshold=response_threshold)
    if len(ia) == 0:
        return graph, 0
    # chain weights are vote counts / responses on a different scale than
    # the loop edges' phase responses; normalize so the median loop edge
    # carries the same weight as the median chain edge (equal trust)
    chain_med = float(np.median(graph.weights)) if len(graph.weights) else 1.0
    wgt = wgt / max(float(np.median(wgt)), 1e-6) * chain_med
    return graph.with_extra_edges(ia, ib, meas, wgt), int(len(ia))
