"""Mesh-distributed pooled feature registration — the flagship, sharded.

The actual flagship algorithm — incremental ROI scale
growth x direction rotation with exact host replay (reference analog:
Stitcher.py:306-367) — over an N-device mesh:

  * the keypoint pool (detect + describe, once per frame) is computed
    frame-sharded under ``shard_map`` — zero communication;
  * each (direction, scale) attempt evaluates ALL adjacent pairs: strip
    masking and per-frame top-k run frame-parallel, then ONE explicit
    shard_map ``ppermute`` ships each shard's first frame's selected
    B-side features to its predecessor (r5 — validated against compiled
    HLO to be exactly the modeled one-frame halo; the earlier auto-sharded
    slicing compiled to full-pool all-gathers), and matching/voting run on
    local pairs;
  * the reference's sequential decision procedure replays unchanged on host
    scalars (core/registration._replay_incremental).

Dispatch policy vs. the single-device ``_PooledCache``: on a mesh the
marginal cost of evaluating a configuration for every pair is one cheap
dispatch, while gathering a pair subset's pool rows to one device costs
real collective/readback traffic — so the sharded cache always computes a
configuration for ALL pairs and the pool never moves.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import StitchConfig, max_roi_scale
from ..core import feature_registration as freg
from ..core import registration as reg
from ..ops.features import detect, match, ransac, vote
from .mesh import pad_to_multiple


@functools.lru_cache(maxsize=32)
def _pool_fn(mesh: Mesh, max_pool: int, dparams, sparams):
    axis = mesh.axis_names[0]

    def local(imgs):
        # the same per-frame pool as the single-device _pool_features_jit:
        # a mesh run must produce the same pool as one device
        return jax.lax.map(
            lambda img: detect.detect_describe_image(img, max_pool, dparams,
                                                     sparams), imgs)

    return jax.jit(shard_map(local, mesh=mesh, in_specs=P(axis),
                             out_specs=P(axis), check_vma=False))


def pool_features_sharded(images_dev, mesh: Mesh, cfg: StitchConfig,
                          sparams=None):
    """Frame-sharded keypoint pool of an (N_pad, H, W) sharded batch."""
    return _pool_fn(mesh, freg._capacity(cfg, cfg.features.pool_keypoints),
                    freg._detect_params(cfg),
                    sparams or freg._describe_params(cfg))(images_dev)


def shard_frames(images: np.ndarray, mesh: Mesh):
    """Pad the frame axis to the mesh size (replicating the last frame) and
    place with a frame-axis NamedSharding.  Returns (sharded, n_true)."""
    n = images.shape[0]
    d = mesh.devices.size
    n_pad = pad_to_multiple(max(n, d), d)
    imgs = np.asarray(images)
    if n_pad != n:
        imgs = np.concatenate([imgs, np.repeat(imgs[-1:], n_pad - n, axis=0)])
    shard = NamedSharding(mesh, P(mesh.axis_names[0]))
    return jax.device_put(imgs, shard), n


@functools.lru_cache(maxsize=256)
def _attempt_all_pairs_fn(mesh: Mesh, bounds_list, k_sel: int, metric: str,
                          vote_method: str):
    """Evaluate (direction, scale) configurations for ALL adjacent pairs —
    explicit-halo shard_map step.

    rows/cols/scores: (N_pad, P); descs: (N_pad, P, D) — frame-sharded.
    Per config: strip-mask + top-k frame-parallel (zero communication),
    then ONE ``ppermute`` ships each shard's FIRST frame's selected B-side
    features (k_sel x (D+3) floats) to its predecessor so every device
    matches its local adjacent pairs without touching the rest of the pool.

    Why shard_map, not auto-sharding: the HLO validator
    (eval/hlo_validation.py) showed an auto-sharded ``feats[:-1]`` /
    ``feats[1:]`` formulation compiling to FULL-pool all-gathers — 33x
    (d=2) to 127x (d=8) the one-frame-halo bytes.  The explicit halo makes
    the compiled collective exactly the modeled one.

    Returns [(drow, dcol, votes, sub_r, sub_c, any_valid)] per config,
    each (N_pad,) with pair k = frames (k, k+1); entries at k >= N-1 are
    padding/wraparound junk the host replay never reads.
    """
    axis = mesh.axis_names[0]
    d = mesh.devices.size
    perm = [(i, (i - 1) % d) for i in range(d)]   # send row-0 to predecessor

    def local(rows, cols, scores, descs, search_ratio, max_distance):
        out = []
        for ba, bb in bounds_list:
            def side(bounds):
                r0, r1, c0, c1 = bounds
                m = ((scores > 0) & (rows >= r0) & (rows < r1)
                     & (cols >= c0) & (cols < c1))
                sel = jnp.where(m, scores, -1.0)
                top_s, top_i = jax.lax.top_k(sel, k_sel)
                take = lambda x: jnp.take_along_axis(x, top_i, axis=-1)
                return (take(rows), take(cols), top_s > 0,
                        jnp.take_along_axis(descs, top_i[..., None], axis=-2))

            ra, ca, va, da = side(ba)
            rb, cb, vb, db = side(bb)
            if d > 1:
                halo = jax.tree.map(
                    lambda x: jax.lax.ppermute(x[:1], axis, perm),
                    (rb, cb, vb, db))
            else:
                halo = (rb[:1], cb[:1], vb[:1], db[:1])
            shift = lambda loc, h: jnp.concatenate([loc[1:], h], axis=0)
            rbn, cbn, vbn, dbn = (shift(x, h) for x, h in
                                  zip((rb, cb, vb, db), halo))
            ti, ok, rb_sel, cb_sel = match.match_batch_coords(
                da, dbn, va, vbn, rbn, cbn,
                search_ratio, max_distance, metric)
            if vote_method == "ransac":
                # strip-local fit + margin re-add (_pool_attempt_jit note)
                dr, dc, nv, av, sr, sc = ransac.ransac_homography_batch(
                    ra - ba[0], ca - ba[2],
                    rb_sel - bb[0], cb_sel - bb[2], ok)
                mr, mc = ba[0] - bb[0], ba[2] - bb[2]
                out.append((dr + mr, dc + mc, nv, sr + mr, sc + mc, av))
                continue
            d_row, d_col, v = jax.vmap(vote.displacement_from_coords)(
                ra, ca, rb_sel, cb_sel, ok)
            if vote_method == "ransac_translation":
                dr, dc, nv, av = vote.ransac_translation_batch(d_row, d_col, v)
                out.append((dr, dc, nv, dr.astype(jnp.float32),
                            dc.astype(jnp.float32), av))
                continue
            dr, dc, nv, av = vote.mode_vote_batch(d_row, d_col, v)
            drf = ra - rb_sel
            dcf = ca - cb_sel
            sr, sc = vote.subpixel_refine_batch(d_row, d_col, drf, dcf, v,
                                                dr, dc)
            out.append((dr, dc, nv, sr, sc, av))
        # pack as one (n_configs, 6, n_local) f32 block: the host replay
        # reads ONE array instead of 6 per config (readback latency
        # dominates tiny fetches; see _pool_attempt_multi_jit)
        return jnp.stack([
            jnp.stack([dr.astype(jnp.float32), dc.astype(jnp.float32),
                       nv.astype(jnp.float32), sr, sc,
                       av.astype(jnp.float32)])
            for dr, dc, nv, sr, sc, av in out])

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P()),
        out_specs=P(None, None, axis), check_vma=False))


def _attempt_all_pairs_jit(rows, cols, scores, descs, bounds_list,
                           k_sel: int, metric: str, search_ratio: float,
                           max_distance: float, vote_method: str,
                           mesh: Mesh = None):
    """Dispatch wrapper: shard_map explicit-halo step (see
    _attempt_all_pairs_fn).  ``mesh`` required; returns a packed
    (n_configs, 6, N_pad) f32 array (drow, dcol, votes, sub_r, sub_c,
    any_valid rows)."""
    fn = _attempt_all_pairs_fn(mesh, bounds_list, k_sel, metric, vote_method)
    return fn(rows, cols, scores, descs,
              jnp.float32(search_ratio), jnp.float32(max_distance))


class ShardedPooledCache:
    """_PooledCache-compatible store that always evaluates all pairs."""

    _SMALL = 16   # <= this many unresolved pairs: speculate all configs

    def __init__(self, pool, cfg: StitchConfig, h: int, w: int, metric: str,
                 mesh: Mesh = None):
        self._pool = pool
        self._cfg = cfg
        self._hw = (h, w)
        self._metric = metric
        self._mesh = mesh
        self._store: Dict[Tuple[int, int], Dict[int, Dict[str, float]]] = {}
        self.dispatches = 0
        self.attempts_matched = 0

    def get(self, direction: int, scale: int, ratio: float, pair: int,
            prefetch) -> Dict[str, float]:
        store = self._store.setdefault((direction, scale), {})
        if pair not in store:
            cfg = self._cfg
            h, w = self._hw
            if len(list(prefetch)) > self._SMALL:
                # all four directions of this scale in the one dispatch
                # (dispatch latency >> the masked top-k + matmul cost; see
                # the single-device _PooledCache policy note)
                configs = [(direction, scale)] + [
                    (d, scale) for d in (1, 2, 3, 4)
                    if d != direction and (d, scale) not in self._store]
            else:
                configs = [(d, s) for s in range(scale, max_roi_scale(ratio))
                           for d in (1, 2, 3, 4)
                           if (d, s) not in self._store]
                if (direction, scale) not in configs:
                    configs.insert(0, (direction, scale))
            bounds = tuple(
                (freg._strip_bounds(d, "first", s * ratio, h, w),
                 freg._strip_bounds(d, "second", s * ratio, h, w))
                for d, s in configs)
            results = np.asarray(_attempt_all_pairs_jit(
                *self._pool, bounds,
                freg._capacity(cfg, cfg.features.max_keypoints),
                self._metric, cfg.features.search_ratio,
                freg._effective_max_distance(cfg), cfg.offset_calculate,
                mesh=self._mesh))
            self.dispatches += 1
            n_pairs = int(results.shape[-1])
            self.attempts_matched += n_pairs * len(configs)
            for (d, s), pk in zip(configs, results):
                dstore = self._store.setdefault((d, s), {})
                nv, sr, sc, av = pk[2], pk[3], pk[4], pk[5]
                for p in range(n_pairs):
                    dstore[p] = {"drow": float(sr[p]), "dcol": float(sc[p]),
                                 "votes": float(nv[p]),
                                 "nz": float(nv[p]) if av[p] > 0.5 else 0.0}
        return store[pair]


def register_sequence_features_incre_sharded(
        images: np.ndarray, cfg: StitchConfig, mesh: Mesh
        ) -> List[reg.PairRegistration]:
    """Mesh-distributed flagship registration: sharded pool + all-pairs
    sharded attempts + exact host replay + oriented fallback.

    Bit-equal to the single-device pooled path (asserted in tests): the
    per-frame pool, strip top-k, matches and votes are the same math on the
    same data; only the partitioning differs.
    """
    n, h, w = images.shape
    if n < 2:
        return []
    images_dev, _ = shard_frames(images, mesh)
    fast = cfg.features.auto_upright and not cfg.features.upright
    cfg_pool = cfg.replace(features=dataclasses.replace(
        cfg.features, upright=True)) if fast else cfg
    pool = pool_features_sharded(images_dev, mesh, cfg_pool)
    _, _, metric = freg._families(cfg_pool)
    cache = ShardedPooledCache(pool, cfg_pool, h, w, metric, mesh=mesh)
    recs = reg._replay_incremental(
        n - 1, cfg_pool, cache, freg._pool_accept(cfg_pool),
        freg._pool_extract, (h, w), offsets_are_full=True)
    if fast and any(not r.ok for r in recs):
        # few frames: replicated oriented fallback (single-device path)
        recs = freg._oriented_fallback_incre(jnp.asarray(images), recs, cfg,
                                             (h, w))
    return recs


def register_sequence_features_sharded(images: np.ndarray, cfg: StitchConfig,
                                       mesh: Mesh
                                       ) -> List[reg.PairRegistration]:
    """Mesh-distributed whole-image feature search (non-incremental): the
    zircon linear-strip path, frame-sharded with halo'd adjacent matching."""
    n, h, w = images.shape
    if n < 2:
        return []
    images_dev, _ = shard_frames(images, mesh)
    fast = cfg.features.auto_upright and not cfg.features.upright
    sparams = freg._describe_params(cfg)
    sparams_fast = dataclasses.replace(sparams, upright=True) if fast \
        else sparams
    max_kp = freg._capacity(cfg, cfg.features.max_keypoints)
    pool = _pool_fn(mesh, max_kp, freg._detect_params(cfg),
                    sparams_fast)(images_dev)
    _, _, metric = freg._families(cfg)
    # whole-frame bounds: the "strip" is the full image
    bounds = ((0, h, 0, w), (0, h, 0, w))
    res = np.asarray(_attempt_all_pairs_jit(
        *pool, (bounds,), max_kp, metric, cfg.features.search_ratio,
        freg._effective_max_distance(cfg), cfg.offset_calculate,
        mesh=mesh))[0]
    dr, dc, nv, sr, sc, av = res
    av = av > 0.5
    out: List[reg.PairRegistration] = []
    for k in range(n - 1):
        okk = bool(nv[k] >= cfg.offset_evaluate)
        out.append(reg.PairRegistration(
            ok=okk, offset=(int(dr[k]), int(dc[k])) if okk else (0, 0),
            offset_subpix=(float(sr[k]), float(sc[k])) if okk else (0.0, 0.0),
            direction=cfg.direction if okk else 0,
            scale=0, confidence=float(nv[k]) if av[k] else 0.0, attempts=1))
    # same no-consensus skip as the single-device path: confidence 0 = the
    # floor-zeroed vote count (zero valid match displacements — nothing for
    # oriented descriptors to rescue)
    failed = [k for k, r in enumerate(out) if not r.ok and r.confidence > 0.0]
    if fast and failed:
        frames = sorted({f for k in failed for f in (k, k + 1)})
        fmap = {f: i for i, f in enumerate(frames)}
        mini = freg._pool_features_jit(
            jnp.asarray(images)[jnp.asarray(frames)], max_kp,
            freg._detect_params(cfg), sparams)
        sub = freg._match_vote_adjacent(
            mini, np.asarray([fmap[k] for k in failed]), cfg, metric)
        for k, r in zip(failed, sub):
            out[k] = r
    return out
