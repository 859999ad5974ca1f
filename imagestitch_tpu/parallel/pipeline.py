"""Sharded batched execution steps.

The multi-chip execution path (SURVEY §2.3): adjacent-pair registration is
data-parallel over a ``pairs`` mesh axis.  Two modes:

  * phase  — pair tensors placed with a ``NamedSharding``; the vmapped FFT
    pipeline auto-partitions (no cross-device communication; the only
    collective is the pose-graph solve's psum);
  * feature (the flagship) — frames sharded over the mesh; detection and
    description run once per frame with zero communication, then an
    EXPLICIT shard_map ``ppermute`` ships each shard's first frame's
    selected features to its predecessor and matching/voting run on local
    pairs with sharded outputs.  (An auto-sharded adjacent-slice
    formulation compiles to full-pool all-gathers — 33-127x the halo
    bytes; eval/hlo_validation.py checks the compiled collectives against
    the one-frame halo.)
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import StitchConfig
from ..ops import phase_corr, roi
from ..ops.features import describe, detect, match, ransac, vote
from ..solver import pose_graph as pg
from .mesh import pad_to_multiple


def make_pair_tensors(images: np.ndarray, mesh: Optional[Mesh] = None
                      ) -> Tuple[jnp.ndarray, jnp.ndarray, int]:
    """(N,H,W) batch -> sharded (P,H,W) A/B pair tensors (P padded to mesh).

    Returns (a, b, n_pairs_valid).  Padding replicates the last pair; callers
    slice results back to ``n_pairs_valid``.
    """
    n_pairs = images.shape[0] - 1
    if mesh is None:
        # ONE upload, slice on device: a[:-1]/b[1:] as host arrays would
        # ship ~2x the batch through the host link (the r4 real-size
        # stretch moved 2.56 GB where 1.28 GB suffices); also accepts an
        # already-device-resident batch as a no-op
        dev = jnp.asarray(images)
        return dev[:-1], dev[1:], n_pairs
    a_np = np.asarray(images)[:-1]
    b_np = np.asarray(images)[1:]
    d = mesh.devices.size
    p_pad = pad_to_multiple(max(n_pairs, d), d)
    if p_pad != n_pairs:
        reps = np.repeat(a_np[-1:], p_pad - n_pairs, axis=0)
        a_np = np.concatenate([a_np, reps])
        b_np = np.concatenate([b_np, np.repeat(b_np[-1:], p_pad - n_pairs, 0)])
    shard = NamedSharding(mesh, P(mesh.axis_names[0]))
    return (jax.device_put(a_np, shard), jax.device_put(b_np, shard), n_pairs)


@functools.partial(jax.jit, static_argnames=("direction", "ratio", "hp", "wp"))
def _register_pairs_jit(a: jnp.ndarray, b: jnp.ndarray, direction: int,
                        ratio: float, hp: int, wp: int):
    ra, rb = roi.extract_strips(a, b, direction, ratio)
    f = jax.vmap(lambda x, y: phase_corr._phase_correlate_one(
        x.astype(jnp.float32), y.astype(jnp.float32), hp, wp))
    return f(ra, rb)


def register_pairs_sharded(a: jnp.ndarray, b: jnp.ndarray, direction: int,
                           ratio: float):
    """Batched phase registration over (possibly sharded) pair tensors."""
    h, w = a.shape[-2], a.shape[-1]
    if direction in (1, 3):
        sh, sw = roi.strip_length(h, ratio), w
    else:
        sh, sw = h, roi.strip_length(w, ratio)
    hp, wp = phase_corr.optimal_dft_size(sh), phase_corr.optimal_dft_size(sw)
    return _register_pairs_jit(a, b, direction, ratio, hp, wp)


@functools.partial(jax.jit, static_argnames=("hp", "wp"))
def _register_pairs_whole_jit(a: jnp.ndarray, b: jnp.ndarray,
                              hp: int, wp: int):
    h, w = a.shape[-2], a.shape[-1]

    def one(uv):
        # cast + mean-subtract PER CHUNK: pre-casting the whole batch to
        # f32 materializes 2 x 5.1 GB at full-resolution tiles
        u = uv[0].astype(jnp.float32)
        v = uv[1].astype(jnp.float32)
        u = u - jnp.mean(u)
        v = v - jnp.mean(v)
        return phase_corr._phase_correlate_one(u, v, hp, wp)

    # chunked map: peak HBM stays at a few GB of padded FFT temporaries —
    # at full-resolution tiles (1936x2584 -> 3888x5184 padded) a plain
    # vmap over 255 pairs demands ~20 GB (measured OOM on the real-size
    # stretch), while chunks keep the pair axis parallel across a mesh
    per_pair = 6 * hp * wp * 8
    chunk = max(1, min(int(a.shape[0]), (2 << 30) // per_pair))
    sx, sy, resp = jax.lax.map(one, (a, b), batch_size=chunk)
    return sx, sy, resp * (float(hp) * wp / (h * w))


def register_pairs_sharded_whole(a: jnp.ndarray, b: jnp.ndarray):
    """Whole-tile LINEAR (2x-padded) phase registration of pair tensors.

    Direction-free: any physically possible shift is unambiguous (same
    repair as core/registration.register_sequence_phase_whole), so one
    dispatch registers a serpentine grid whose in-row and row-transition
    pairs move in different directions.  Offsets = (-sy, -sx).
    """
    h, w = a.shape[-2], a.shape[-1]
    hp = phase_corr.optimal_dft_size(2 * h)
    wp = phase_corr.optimal_dft_size(2 * w)
    return _register_pairs_whole_jit(a, b, hp, wp)


def _feature_pairs_body(images, max_kp: int, k_sel: int, dparams, sparams,
                        metric: str, search_ratio, max_distance,
                        bounds_a, bounds_b, vote_method: str, halo):
    """Per-block feature attempt math shared by the single-device jit and
    the shard_map step.  ``halo(tuple)`` maps the local B-side feature
    tuple to the one aligned so pair k = A[k] vs B[k+1] (identity slicing
    single-device; ppermute boundary exchange on a mesh — in that case the
    result keeps the local length and trailing entries are wraparound junk
    the caller drops)."""
    rows, cols, scores, descs = jax.vmap(
        lambda im: detect.detect_describe_image(im, max_kp, dparams,
                                                sparams))(images)

    def side(bounds):
        r0, r1, c0, c1 = bounds
        m = ((scores > 0) & (rows >= r0) & (rows < r1)
             & (cols >= c0) & (cols < c1))
        sel = jnp.where(m, scores, -1.0)
        top_s, top_i = jax.lax.top_k(sel, k_sel)
        take = lambda x: jnp.take_along_axis(x, top_i, axis=-1)
        return (take(rows), take(cols), top_s > 0,
                jnp.take_along_axis(descs, top_i[..., None], axis=-2))

    ra, ca, va, da = side(bounds_a)
    rb, cb, vb, db = side(bounds_b)
    rbn, cbn, vbn, dbn = halo((rb, cb, vb, db))
    n_a = rbn.shape[0]
    ra, ca, va, da = ra[:n_a], ca[:n_a], va[:n_a], da[:n_a]
    ti, ok = match.match_batch(da, dbn, va, vbn,
                               search_ratio, max_distance, metric)
    if vote_method == "ransac":
        # strip-local fit + margin re-add (the homography translation
        # column is frame-dependent; see _pool_attempt_jit note)
        rbs = jnp.take_along_axis(rbn, ti, axis=-1)
        cbs = jnp.take_along_axis(cbn, ti, axis=-1)
        dr, dc, nv, _, sr, sc = ransac.ransac_homography_batch(
            ra - bounds_a[0], ca - bounds_a[2],
            rbs - bounds_b[0], cbs - bounds_b[2], ok)
        mr, mc = bounds_a[0] - bounds_b[0], bounds_a[2] - bounds_b[2]
        return dr + mr, dc + mc, nv, sr + mr, sc + mc
    d_row, d_col, v = jax.vmap(vote.displacement_from_matches)(
        ra, ca, rbn, cbn, ti, ok)
    if vote_method == "ransac_translation":
        dr, dc, nv, _ = vote.ransac_translation_batch(d_row, d_col, v)
        return dr, dc, nv, dr.astype(jnp.float32), dc.astype(jnp.float32)
    dr, dc, nv, _ = vote.mode_vote_batch(d_row, d_col, v)
    drf, dcf = jax.vmap(vote.displacement_from_matches_f)(
        ra, ca, rbn, cbn, ti)
    sr, sc = vote.subpixel_refine_batch(d_row, d_col, drf, dcf, v, dr, dc)
    return dr, dc, nv, sr, sc


@functools.partial(jax.jit, static_argnames=(
    "max_kp", "k_sel", "dparams", "sparams", "metric", "bounds_a",
    "bounds_b", "vote_method"))
def _feature_pairs_jit(images: jnp.ndarray, max_kp: int, k_sel: int,
                       dparams, sparams, metric: str,
                       search_ratio: float, max_distance: float,
                       bounds_a, bounds_b, vote_method: str):
    """Single-device feature registration step over an (N, H, W) batch.

    One (direction, scale) strip attempt for every adjacent pair: pooled
    per-frame detect+describe, strip-masked top-k per side, MXU matching,
    mode/ransac vote.  Returns per-pair (drow, dcol, votes, subpix_row,
    subpix_col), each (N-1,)."""
    halo = lambda t: tuple(x[1:] for x in t)
    return _feature_pairs_body(images, max_kp, k_sel, dparams, sparams,
                               metric, search_ratio, max_distance,
                               bounds_a, bounds_b, vote_method, halo)


@functools.lru_cache(maxsize=64)
def _feature_pairs_sharded_fn(mesh: Mesh, max_kp: int, k_sel: int,
                              dparams, sparams, metric: str,
                              bounds_a, bounds_b, vote_method: str):
    """Explicit-halo shard_map feature step over a frame-sharded batch.

    Detection and strip top-k run frame-parallel with zero communication;
    ONE ``ppermute`` then ships each shard's first frame's selected B-side
    features to its predecessor, and matching/voting run on local pairs.
    (r5: the auto-sharded adjacent-slice formulation compiled to full-pool
    all-gathers — 33-127x the modeled halo; eval/hlo_validation.py.)
    Outputs are (N_pad,); entries at k >= N-1 are padding/wraparound junk.
    """
    axis = mesh.axis_names[0]
    d = mesh.devices.size
    perm = [(i, (i - 1) % d) for i in range(d)]

    def local(images, search_ratio, max_distance):
        def halo(t):
            if d > 1:
                h = jax.tree.map(
                    lambda x: jax.lax.ppermute(x[:1], axis, perm), t)
            else:
                h = tuple(x[:1] for x in t)
            return tuple(jnp.concatenate([x[1:], hx], axis=0)
                         for x, hx in zip(t, h))

        return _feature_pairs_body(images, max_kp, k_sel, dparams, sparams,
                                   metric, search_ratio, max_distance,
                                   bounds_a, bounds_b, vote_method, halo)

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P(axis), P(), P()),
                             out_specs=P(axis), check_vma=False))


def _feature_call_args(images: np.ndarray, mesh: Optional[Mesh],
                       cfg: Optional[StitchConfig], direction: int,
                       ratio: float):
    """Shared arg preparation for the sharded feature step (run + HLO probe)."""
    from ..core import feature_registration as freg
    cfg = cfg or StitchConfig()
    n, h, w = images.shape
    imgs = np.asarray(images)
    if mesh is not None:
        d = mesh.devices.size
        n_pad = pad_to_multiple(max(n, d), d)
        if n_pad != n:
            imgs = np.concatenate(
                [imgs, np.repeat(imgs[-1:], n_pad - n, axis=0)])
        imgs = jax.device_put(imgs, NamedSharding(mesh, P(mesh.axis_names[0])))
    else:
        imgs = jnp.asarray(imgs)
    bounds_a = freg._strip_bounds(direction, "first", ratio, h, w)
    bounds_b = freg._strip_bounds(direction, "second", ratio, h, w)
    _, _, metric = freg._families(cfg)
    args = (imgs, freg._capacity(cfg, cfg.features.pool_keypoints),
            freg._capacity(cfg, cfg.features.max_keypoints),
            freg._detect_params(cfg), freg._describe_params(cfg), metric,
            cfg.features.search_ratio, freg._effective_max_distance(cfg),
            bounds_a, bounds_b, cfg.offset_calculate)
    return n, args


def register_pairs_sharded_features(images: np.ndarray, mesh: Optional[Mesh],
                                    cfg: Optional[StitchConfig] = None,
                                    direction: int = 1, ratio: float = 0.5):
    """Frame-sharded feature registration of all adjacent pairs.

    Returns host arrays (drow, dcol, votes, subpix_row, subpix_col), each
    (N-1,), full-image offsets (pooled-path semantics: margin pre-cancelled).
    """
    n, args = _feature_call_args(images, mesh, cfg, direction, ratio)
    out = _feature_step_dispatch(mesh, args)
    return tuple(np.asarray(x)[:n - 1] for x in out)


def _feature_step_dispatch(mesh: Optional[Mesh], args):
    """Route a prepared feature-step call: explicit-halo shard_map on a
    real mesh, the plain jit single-device."""
    (imgs, max_kp, k_sel, dparams, sparams, metric, search_ratio,
     max_distance, ba, bb, vm) = args
    if mesh is not None and mesh.devices.size > 1:
        fn = _feature_pairs_sharded_fn(mesh, max_kp, k_sel, dparams,
                                       sparams, metric, ba, bb, vm)
        return fn(imgs, jnp.float32(search_ratio), jnp.float32(max_distance))
    return _feature_pairs_jit(*args)


def feature_step_collectives(images: np.ndarray, mesh: Optional[Mesh],
                             cfg: Optional[StitchConfig] = None,
                             direction: int = 1, ratio: float = 0.5):
    """Compiled-HLO collective counts of the sharded feature step
    (the scaling harness's hardware-independent evidence)."""
    from ..utils import hlo
    _, args = _feature_call_args(images, mesh, cfg, direction, ratio)
    (imgs, max_kp, k_sel, dparams, sparams, metric, search_ratio,
     max_distance, ba, bb, vm) = args
    if mesh is not None and mesh.devices.size > 1:
        fn = _feature_pairs_sharded_fn(mesh, max_kp, k_sel, dparams,
                                       sparams, metric, ba, bb, vm)
        return hlo.count_collectives(fn, imgs, jnp.float32(search_ratio),
                                     jnp.float32(max_distance))
    return hlo.count_collectives(_feature_pairs_jit, *args)


def distributed_stitch_step_features(images: np.ndarray, mesh: Mesh,
                                     cfg: Optional[StitchConfig] = None,
                                     direction: int = 1, ratio: float = 0.5,
                                     cg_iters: int = 64) -> np.ndarray:
    """Flagship multi-chip step: frame-sharded FEATURE registration ->
    pose-graph solve with psum over the mesh.  Returns (N, 2) poses."""
    cfg = cfg or StitchConfig()
    dr, dc, nv, sr, sc = register_pairs_sharded_features(
        images, mesh, cfg, direction, ratio)
    offsets = np.stack([sr, sc], axis=1)
    conf = np.maximum(nv.astype(np.float64), 1e-3)
    graph = pg.PoseGraph.from_chain([tuple(o) for o in offsets], conf)
    return pg.solve(graph, iters=cg_iters, mesh=mesh)


def distributed_stitch_step(images: np.ndarray, mesh: Mesh,
                            direction: int = 1, ratio: float = 0.25,
                            cg_iters: int = 64) -> np.ndarray:
    """One full distributed pipeline step: sharded registration -> global
    pose solve with psum over the mesh.  Returns absolute (N, 2) poses.

    This is the multi-chip 'training step' analog validated by
    ``__graft_entry__.dryrun_multichip``.
    """
    a, b, n_pairs = make_pair_tensors(images, mesh)
    sx, sy, resp = register_pairs_sharded(a, b, direction, ratio)
    sx = np.asarray(sx)[:n_pairs]
    sy = np.asarray(sy)[:n_pairs]
    resp = np.asarray(resp)[:n_pairs]
    h, _ = images.shape[1], images.shape[2]
    mr, mc = roi.margin_correction(direction, images.shape[1:3],
                                   images.shape[1:3], ratio)
    # cv2-style (x, y) is minus the displacement: strip offset = (-y, -x)
    offsets = np.stack([-sy + mr, -sx + mc], axis=1)
    graph = pg.PoseGraph.from_chain(
        [tuple(o) for o in offsets], np.maximum(resp, 1e-3))
    return pg.solve(graph, iters=cg_iters, mesh=mesh)
