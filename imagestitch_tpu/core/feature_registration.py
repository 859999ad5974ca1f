"""Feature-search registration (incremental and whole-image).

Batched rebuild of the reference's feature registrars:
  * ``register_sequence_features_incre`` — calculateOffsetForFeatureSearchIncre
    (reference: Stitcher.py:306-367), the VFSMS core;
  * ``register_sequence_features``       — calculateOffsetForFeatureSearch
    (reference: Stitcher.py:260-304).

Execution model (contrast with the reference's one-OpenCV-call-per-attempt
host loop): each (direction, scale) configuration evaluates detection,
description, matmul matching and mode voting for EVERY pair in chunked batched
dispatches; the reference's sequential scale-growth/direction-rotation
decision procedure then replays on host scalars (core/registration.py).

Feature-cache parity: the reference caches image B's features to reuse as the
next pair's A (Stitcher.py:14-18, :278-290).  Our batched whole-image path
detects every image's features exactly once per sequence — the cache's effect
(each image detected once) is structural, and results are identical because
detection is deterministic and independent of pair order.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import StitchConfig
from ..ops import enhance, roi
from ..ops.features import describe, detect, match, ransac, vote
from . import registration as reg


def _enhance_mode(cfg: StitchConfig) -> str:
    if not cfg.enhance.enabled:
        return "none"
    return "clahe" if cfg.enhance.use_clahe else "equalize"


def _families(cfg: StitchConfig) -> Tuple[str, str, str]:
    """(detector_family, descriptor_family, metric) per featureMethod."""
    m = cfg.features.method
    if m == "orb":
        return "corner", "orb", "hamming"
    if m == "sift":
        return "hessian", "sift", "l2"
    if m == "surf" and cfg.features.extended:
        return "hessian", "surf-extended", "l2"
    return "hessian", "surf", "l2"


def _detect_params(cfg: StitchConfig) -> detect.DetectParams:
    """Static detector parameters from config (ImageUtility.py:23-40 knobs)."""
    f = cfg.features
    fam, _, _ = _families(cfg)
    return detect.DetectParams(
        family=fam, threshold=f.hessian_threshold,
        n_octaves=f.n_octaves, n_octave_layers=f.n_octave_layers,
        box_filter=f.box_filter, subpixel=f.subpixel,
        n_levels=f.orb_n_levels, scale_factor=f.orb_scale_factor,
        first_level=f.orb_first_level,
        fast_threshold=float(f.orb_fast_threshold),
        edge_threshold=f.orb_edge_threshold,
        dtype=cfg.compute_dtype,
        octave_topk_decay=f.octave_topk_decay)


def _describe_params(cfg: StitchConfig) -> describe.DescribeParams:
    """Static descriptor parameters from config."""
    f = cfg.features
    _, fam, _ = _families(cfg)
    return describe.DescribeParams(
        family=fam, upright=f.upright,
        patch_size=f.orb_patch_size, wta_k=f.orb_wta_k)


def _capacity(cfg: StitchConfig, requested: int) -> int:
    """Keypoint capacity, capped by orb_n_features for the ORB family
    (ImageUtility.py:31 nfeatures=5000)."""
    if cfg.features.method == "orb":
        return min(requested, cfg.features.orb_n_features)
    return requested


@functools.partial(jax.jit, static_argnames=(
    "direction", "ratio", "max_kp", "dparams", "sparams", "metric",
    "vote_method", "enhance_mode", "enhance_tiles"))
def _feature_attempt_pairs_jit(a: jnp.ndarray, b: jnp.ndarray,
                         direction: int, ratio: float,
                         max_kp: int, dparams: detect.DetectParams,
                         sparams: "describe.DescribeParams",
                         metric: str, search_ratio: float,
                         max_distance: float, vote_method: str = "mode",
                         enhance_mode: str = "none",
                         enhance_clip: float = 20.0, enhance_tiles: int = 5):
    """One (direction, scale) attempt for a batch of explicit (A, B) pairs.

    a, b: (C, H, W) uint8 batches (pair k = a[k] vs b[k]).
    Returns per-pair (drow_strip, dcol_strip, votes) arrays of shape (C,).
    """
    ra, rb = roi.extract_strips(a, b, direction, ratio)
    if enhance_mode != "none":
        # reference enhances the ROI strips in-place (Stitcher.py:327-334)
        ra = enhance.enhance_batch(ra, enhance_mode == "clahe",
                                   enhance_clip, enhance_tiles)
        rb = enhance.enhance_batch(rb, enhance_mode == "clahe",
                                   enhance_clip, enhance_tiles)
    fused = lambda im: detect.detect_describe_image(im, max_kp, dparams,
                                                    sparams)
    rows_a, cols_a, sc_a, da = jax.vmap(fused)(ra)
    rows_b, cols_b, sc_b, db = jax.vmap(fused)(rb)
    valid_a = sc_a > 0
    valid_b = sc_b > 0
    train_idx, ok = match.match_batch(da, db, valid_a, valid_b,
                                      search_ratio, max_distance, metric)
    if vote_method == "ransac":
        rb_sel = jnp.take_along_axis(rows_b, train_idx, axis=-1)
        cb_sel = jnp.take_along_axis(cols_b, train_idx, axis=-1)
        dr, dc, nv, av, _, _ = ransac.ransac_homography_batch(
            rows_a, cols_a, rb_sel, cb_sel, ok)
        return dr, dc, nv, av
    d_row, d_col, v = jax.vmap(vote.displacement_from_matches)(
        rows_a, cols_a, rows_b, cols_b, train_idx, ok)
    if vote_method == "ransac_translation":
        return vote.ransac_translation_batch(d_row, d_col, v)
    return vote.mode_vote_batch(d_row, d_col, v)  # (dr, dc, n, any_valid)


def _effective_max_distance(cfg: StitchConfig) -> float:
    """orbMaxDistance in descriptor-distance units: WTA_K>2 one-hot symbols
    make the Hamming matmul count 2 per mismatched symbol."""
    d = float(cfg.features.orb_max_distance)
    return d * 2.0 if cfg.features.orb_wta_k > 2 else d


def _strict_attempt(images_dev, direction: int, ratio: float,
                    idx: np.ndarray, cfg: StitchConfig
                    ) -> Dict[str, np.ndarray]:
    """Per-ROI detection attempt for an explicit pair subset (strict parity
    mode: the detector sees exactly the strip, as the reference does)."""
    _, _, metric = _families(cfg)
    dparams = _detect_params(cfg)
    sparams = _describe_params(cfg)
    h, w = images_dev.shape[1:3]
    max_kp = _capacity(cfg, cfg.features.max_keypoints)
    if direction in (1, 3):
        strip_px = roi.strip_length(h, ratio) * w
    else:
        strip_px = h * roi.strip_length(w, ratio)
    dist_chunk = max(1, (1 << 28) // (4 * max_kp * max_kp))
    conv_chunk = max(1, (12 << 30) // (strip_px * 4 * 100))
    chunk = cfg.pair_batch or min(dist_chunk, conv_chunk)
    drows, dcols, votes, nzs = [], [], [], []
    for s in range(0, len(idx), chunk):
        sub, keep = reg.pad_indices(idx[s:s + chunk])
        # build a (B+1)-image slice whose adjacent pairs are exactly `sub`:
        # gather A images then append each B — use explicit A/B stacking
        imgs = jnp.concatenate([images_dev[jnp.asarray(sub)],
                                images_dev[jnp.asarray(sub) + 1]])
        b = len(sub)
        dr, dc, nv, av = _feature_attempt_pairs_jit(
            imgs[:b], imgs[b:], direction, ratio, max_kp,
            dparams, sparams, metric,
            cfg.features.search_ratio,
            _effective_max_distance(cfg),
            vote_method=cfg.offset_calculate,
            enhance_mode=_enhance_mode(cfg),
            enhance_clip=cfg.enhance.clip_limit,
            enhance_tiles=cfg.enhance.tile_size)
        drows.append(np.asarray(dr)[:keep])
        dcols.append(np.asarray(dc)[:keep])
        nv = np.asarray(nv)[:keep]
        votes.append(nv)
        # "nz": votes with the empty-displacement floor zeroed out —
        # distinguishes "no valid matches at all" from a real 1-vote mode
        nzs.append(np.where(np.asarray(av)[:keep], nv, 0))
    return {"drow": np.concatenate(drows), "dcol": np.concatenate(dcols),
            "votes": np.concatenate(votes), "nz": np.concatenate(nzs)}


# ---------------------------------------------------------------------------
# Pooled fast path: detect/describe each image ONCE on the full frame, then
# evaluate every (direction, scale) attempt by masking the keypoint pool to
# the strip.  Exactly equivalent decision data: the reference's strip-local
# displacement + margin correction equals the full-image displacement
# (integer strip origins cancel under int() truncation), so the mode vote
# over in-strip matches yields the identical offset.  The detector context
# differs only within a filter-radius band at strip borders.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("max_pool", "dparams",
                                             "sparams"))
def _pool_features_jit(images: jnp.ndarray, max_pool: int,
                       dparams: detect.DetectParams,
                       sparams: describe.DescribeParams):
    """Detect+describe the whole (N, H, W) batch in ONE dispatch.

    ``lax.map`` over frames bounds peak device memory to a single frame's
    conv temporaries (XLA reuses loop buffers) while dispatching once.
    """
    return jax.lax.map(
        lambda img: detect.detect_describe_image(img, max_pool, dparams,
                                                 sparams), images)


def _precompute_pool(images_dev, cfg: StitchConfig):
    pool = _capacity(cfg, cfg.features.pool_keypoints)
    return _pool_features_jit(images_dev, pool, _detect_params(cfg),
                              _describe_params(cfg))


def _strip_bounds(direction: int, order: str, ratio: float, h: int, w: int):
    """Full-image-coordinate bounds (r0, r1, c0, c1) of the search strip
    (getROIRegionForIncreMethod semantics, ImageUtility.py:77-100)."""
    if direction in (1, 3):
        L = roi.strip_length(h, ratio)
        first_low = direction == 3  # dir 3: A top strip
        if (order == "first") != first_low:
            return h - L, h, 0, w
        return 0, L, 0, w
    L = roi.strip_length(w, ratio)
    first_low = direction == 4      # dir 4: A left strip
    if (order == "first") != first_low:
        return 0, h, w - L, w
    return 0, h, 0, L


@functools.partial(jax.jit, static_argnames=(
    "bounds_a", "bounds_b", "k_sel", "metric", "vote_method"))
def _pool_attempt_jit(rows, cols, scores, descs, idx: jnp.ndarray,
                      bounds_a, bounds_b, k_sel: int, metric: str,
                      search_ratio: float, max_distance: float,
                      vote_method: str):
    """One (direction, scale) attempt for pair subset ``idx`` from the pool.

    rows/cols/scores: (N, P); descs: (N, P, D).  Returns (drow, dcol, votes)
    per pair — FULL-image offsets (margin correction pre-cancelled).
    """
    def side(i, bounds):
        r = rows[i]
        c = cols[i]
        s = scores[i]
        r0, r1, c0, c1 = bounds
        m = (s > 0) & (r >= r0) & (r < r1) & (c >= c0) & (c < c1)
        # top-k_sel by score among in-strip keypoints
        sel = jnp.where(m, s, -1.0)
        top_s, top_i = jax.lax.top_k(sel, k_sel)
        take = lambda x: jnp.take_along_axis(x, top_i, axis=-1)
        valid = top_s > 0
        return take(r), take(c), valid, jnp.take_along_axis(
            descs[i], top_i[..., None], axis=-2)

    ra, ca, va, da = side(idx, bounds_a)
    rb, cb, vb, db = side(idx + 1, bounds_b)
    ti, ok, rb_sel, cb_sel = match.match_batch_coords(
        da, db, va, vb, rb, cb, search_ratio, max_distance, metric)
    if vote_method == "ransac":
        # reference semantics: cv2.findHomography(RANSAC, 3) + inlier count
        # + negated truncated H translation (ImageUtility.py:180-210).
        # The homography is fit in STRIP-LOCAL coordinates, as the
        # reference does — H's translation column is frame-dependent when
        # its linear part is not exactly identity (measured 9 px shift on
        # the dendritic pair between strip and full frames), so full-image
        # coords would change the estimator.  Margins (integer strip
        # origins) are re-added after; int truncation commutes with the
        # integer shift.
        dr, dc, nv, av, sr, sc = ransac.ransac_homography_batch(
            ra - bounds_a[0], ca - bounds_a[2],
            rb_sel - bounds_b[0], cb_sel - bounds_b[2], ok)
        mr = bounds_a[0] - bounds_b[0]
        mc = bounds_a[2] - bounds_b[2]
        return dr + mr, dc + mc, nv, sr + mr, sc + mc, av
    d_row, d_col, v = jax.vmap(vote.displacement_from_coords)(
        ra, ca, rb_sel, cb_sel, ok)
    if vote_method == "ransac_translation":
        dr, dc, nv, av = vote.ransac_translation_batch(d_row, d_col, v)
        return (dr, dc, nv, dr.astype(jnp.float32), dc.astype(jnp.float32),
                av)
    dr, dc, nv, av = vote.mode_vote_batch(d_row, d_col, v)
    drf = ra - rb_sel
    dcf = ca - cb_sel
    sr, sc = vote.subpixel_refine_batch(d_row, d_col, drf, dcf, v, dr, dc)
    return dr, dc, nv, sr, sc, av


@functools.partial(jax.jit, static_argnames=(
    "bounds_list", "k_sel", "metric", "vote_method"))
def _pool_attempt_multi_jit(rows, cols, scores, descs, idx: jnp.ndarray,
                            bounds_list, k_sel: int, metric: str,
                            search_ratio: float, max_distance: float,
                            vote_method: str):
    """Several directions of one scale in a single dispatch.

    After a direction turn the replay probes several directions, so
    computing them up front turns N dispatch + readback round trips into
    one.  Results come back PACKED as one (n_configs, 6, P) float32 array,
    because the replay reads host scalars and each small readback pays a
    fixed latency.  Rows: drow, dcol, votes, sub_r, sub_c, any_valid (all
    values exact in f32: offsets < 2^12).
    """
    out = []
    for ba, bb in bounds_list:
        dr, dc, nv, sr, sc, av = _pool_attempt_jit(
            rows, cols, scores, descs, idx, ba, bb, k_sel, metric,
            search_ratio, max_distance, vote_method)
        out.append(jnp.stack([dr.astype(jnp.float32), dc.astype(jnp.float32),
                              nv.astype(jnp.float32), sr, sc,
                              av.astype(jnp.float32)]))
    return jnp.stack(out)


class _PooledCache:
    """AttemptCache-compatible store over the keypoint pool.

    Dispatch policy: a big sweep (every unresolved pair) computes ALL FOUR
    directions of the requested scale in the one dispatch — the extra
    three directions cost only masked top-k + matmul time, and a serpentine
    grid's alternating rows need directions 1/2/3 anyway.  Small misses
    (the few pairs that survive to a deeper scale) speculate every
    remaining (direction, scale) configuration at once.  (r4 note: leaner
    sweeps — {dir, opposite} and {dir, opposite, rotation} — were measured
    on the flagship and bought nothing: the first pair of the dendritic
    sequence is the permanently-unstitchable one, so every direction gets
    demanded immediately and the narrow sweeps just add a dispatch.)
    """

    _SMALL = 16   # <= this many pairs: speculate all 4 directions

    def __init__(self, pool, cfg: StitchConfig, h: int, w: int, metric: str):
        self._pool = pool
        self._cfg = cfg
        self._hw = (h, w)
        self._metric = metric
        self._store: Dict[Tuple[int, int], Dict[int, Dict[str, float]]] = {}
        self.dispatches = 0
        self.attempts_matched = 0   # (pair, direction, scale) matmuls issued

    def get(self, direction: int, scale: int, ratio: float, pair: int,
            prefetch) -> Dict[str, float]:
        store = self._store.setdefault((direction, scale), {})
        if pair not in store:
            todo = [pair] + [p for p in prefetch
                             if p != pair and p not in store]
            idx = np.asarray(sorted(todo), np.int32)
            idx_p, keep = reg.pad_indices(idx)
            h, w = self._hw
            cfg = self._cfg
            if len(idx) > self._SMALL:
                configs = [(direction, scale)] + [
                    (d, scale) for d in (1, 2, 3, 4)
                    if d != direction and (d, scale) not in self._store]
            else:
                # stragglers: every (direction, remaining scale) at once —
                # the replay will rotate through most of them anyway
                from ..config import max_roi_scale
                configs = [(d, s) for s in range(scale,
                                                 max_roi_scale(ratio))
                           for d in (1, 2, 3, 4)]
            bounds = tuple(
                (_strip_bounds(d, "first", s * ratio, h, w),
                 _strip_bounds(d, "second", s * ratio, h, w))
                for d, s in configs)
            results = np.asarray(_pool_attempt_multi_jit(
                *self._pool, jnp.asarray(idx_p), bounds,
                _capacity(cfg, cfg.features.max_keypoints), self._metric,
                cfg.features.search_ratio,
                _effective_max_distance(cfg), cfg.offset_calculate))
            self.dispatches += 1
            self.attempts_matched += len(idx_p) * len(configs)
            for (d, s), pk in zip(configs, results):
                dstore = self._store.setdefault((d, s), {})
                nv = pk[2][:keep]
                sr = pk[3][:keep]
                sc = pk[4][:keep]
                av = pk[5][:keep]
                for j, p in enumerate(idx):
                    dstore[int(p)] = {"drow": float(sr[j]),
                                      "dcol": float(sc[j]),
                                      "votes": float(nv[j]),
                                      "nz": float(nv[j]) if av[j] > 0.5
                                            else 0.0}
        return store[pair]


def _pool_accept(cfg: StitchConfig):
    def accept(res: Dict[str, float]) -> bool:
        return bool(res["votes"] >= cfg.offset_evaluate)
    return accept


def _pool_extract(res: Dict[str, float]):
    # confidence = the FLOOR-ZEROED vote count ("nz"): 0 when the attempt had
    # no valid displacements at all, so downstream retry gates can tell the
    # reference's empty floor (votes=1, ImageUtility.py:173-176) from a real
    # 1-vote mode.  The ACCEPT decision still uses the parity "votes" value.
    return float(res["drow"]), float(res["dcol"]), float(res["nz"])


# Introspection (tests/bench): dispatch + matmul accounting of the most
# recent replay_from_pool call.
LAST_REPLAY_STATS: Dict[str, float] = {}


def replay_from_pool(pool, n: int, shape: Tuple[int, int], cfg: StitchConfig,
                     pairs=None) -> List[reg.PairRegistration]:
    """The reference's sequential decision replay over a precomputed
    keypoint pool (rows, cols, scores, descs)."""
    h, w = shape
    _, _, metric = _families(cfg)
    cache = _PooledCache(pool, cfg, h, w, metric)
    out = reg._replay_incremental(n - 1, cfg, cache, _pool_accept(cfg),
                                  _pool_extract, (h, w),
                                  offsets_are_full=True, pairs=pairs)
    LAST_REPLAY_STATS.clear()
    LAST_REPLAY_STATS.update(
        dispatches=cache.dispatches,
        attempts_matched=cache.attempts_matched,
        k_sel=_capacity(cfg, cfg.features.max_keypoints),
        desc_dim=int(pool[3].shape[-1]))
    return out


def _oriented_fallback_incre(images_dev, recs: List[reg.PairRegistration],
                             cfg: StitchConfig, shape: Tuple[int, int]
                             ) -> List[reg.PairRegistration]:
    """Re-register the pairs the upright fast path could not, with the full
    ORIENTED descriptor pipeline — but only over the frames those pairs
    touch, so one stubborn pair costs a two-frame pool, not a sequence
    recompute.

    Pairs whose attempts never produced a single VALID match displacement
    (confidence == 0: the floor-zeroed vote count, see _pool_extract) are
    skipped — with zero upright matches surviving the ratio test there is
    no signal for orientation to rescue, and the permanently-impossible
    missing-frame dendritic pair otherwise forces a two-frame oriented
    pool + replay EVERY run.  A real low-vote mode
    (confidence 1-2) IS retried: rotated pairs — exactly the case this
    fallback exists for — often yield only 1-2 agreeing upright matches
   ."""
    failed = [k for k, r in enumerate(recs)
              if not r.ok and r.confidence > 0.0]
    if not failed:
        return recs
    frames = sorted({f for k in failed for f in (k, k + 1)})
    fmap = {f: i for i, f in enumerate(frames)}
    # for a failed pair k both k and k+1 are in ``frames`` with no integer
    # between them, so mini-index(k) + 1 == mini-index(k+1) always holds
    mini = _pool_features_jit(
        images_dev[jnp.asarray(frames)],
        _capacity(cfg, cfg.features.pool_keypoints),
        _detect_params(cfg), _describe_params(cfg))
    h, w = shape
    _, _, metric = _families(cfg)
    cache = _PooledCache(mini, cfg, h, w, metric)
    direction = cfg.direction
    for k in range(failed[0] - 1, -1, -1):
        if recs[k].ok and recs[k].direction:
            direction = recs[k].direction
            break
    sub = reg._replay_incremental(
        len(frames) - 1, cfg.replace(direction=direction), cache,
        _pool_accept(cfg), _pool_extract, (h, w), offsets_are_full=True,
        pairs=[fmap[k] for k in failed])
    out = list(recs)
    for k, r in zip(failed, sub):
        out[k] = r
    return out


def register_sequence_features_incre(images: np.ndarray, cfg: StitchConfig
                                     ) -> List[reg.PairRegistration]:
    """Incremental ROI feature search over a (N, H, W) grayscale batch.

    Default engine: pooled fast path (detect once per image).  Set
    ``cfg.features.strict_roi_detect`` for the reference's per-ROI detection.
    """
    images_dev = jnp.asarray(images)
    n, h, w = images.shape
    if n < 2:
        return []

    emode = _enhance_mode(cfg)
    use_strict = cfg.features.strict_roi_detect or emode != "none"
    if not use_strict:
        # upright-first fast path (auto_upright): orientation estimation is
        # ~85% of pooled detect/describe device time and buys nothing on
        # translation-only stages; pairs the upright pool cannot register
        # fall back to the oriented pipeline over just their frames.
        fast = cfg.features.auto_upright and not cfg.features.upright
        cfg_pool = cfg.replace(features=dataclasses.replace(
            cfg.features, upright=True)) if fast else cfg
        pool = _precompute_pool(images_dev, cfg_pool)
        recs = replay_from_pool(pool, n, (h, w), cfg_pool)
        if fast and any(not r.ok for r in recs):
            recs = _oriented_fallback_incre(images_dev, recs, cfg, (h, w))
        return recs
    else:
        def evaluator(direction: int, ratio: float, idx: np.ndarray
                      ) -> Dict[str, np.ndarray]:
            return _strict_attempt(images_dev, direction, ratio, idx, cfg)

        offsets_are_full = False

    cache = reg.AttemptCache(evaluator)

    def accept(res: Dict[str, float]) -> bool:
        return bool(res["votes"] >= cfg.offset_evaluate)

    def extract(res: Dict[str, float]):
        # already integer (truncated) offsets; confidence = floor-zeroed
        # vote count (0 when no valid displacements existed — _pool_extract)
        return float(res["drow"]), float(res["dcol"]), float(res["nz"])

    return reg._replay_incremental(n - 1, cfg, cache, accept, extract, (h, w),
                                   offsets_are_full=offsets_are_full)


def _match_vote_adjacent(pool, ia: np.ndarray, cfg: StitchConfig,
                         metric: str) -> List[reg.PairRegistration]:
    """Match + vote frame pairs (ia[k], ia[k]+1-in-pool-order) of a pooled
    feature set.  ``ia``: pool indices of each pair's A frame; B = ia + 1."""
    rows, cols, scores, descs = pool
    valid = scores > 0
    out: List[reg.PairRegistration] = []
    max_kp = descs.shape[1]
    pchunk = max(1, (1 << 28) // (4 * max_kp * max_kp))
    for s in range(0, len(ia), pchunk):
        sub = jnp.asarray(ia[s:s + pchunk])
        ti, ok = match.match_batch(
            descs[sub], descs[sub + 1], valid[sub], valid[sub + 1],
            cfg.features.search_ratio, _effective_max_distance(cfg),
            metric)
        if cfg.offset_calculate == "ransac":
            rb_sel = jnp.take_along_axis(rows[sub + 1], ti, axis=-1)
            cb_sel = jnp.take_along_axis(cols[sub + 1], ti, axis=-1)
            dr, dc, nv, av, _, _ = ransac.ransac_homography_batch(
                rows[sub], cols[sub], rb_sel, cb_sel, ok)
        else:
            d_row, d_col, v = jax.vmap(vote.displacement_from_matches)(
                rows[sub], cols[sub], rows[sub + 1], cols[sub + 1], ti, ok)
            if cfg.offset_calculate == "ransac_translation":
                dr, dc, nv, av = vote.ransac_translation_batch(d_row, d_col, v)
            else:
                dr, dc, nv, av = vote.mode_vote_batch(d_row, d_col, v)
        dr, dc, nv = np.asarray(dr), np.asarray(dc), np.asarray(nv)
        av = np.asarray(av)
        for k in range(len(ia[s:s + pchunk])):
            okk = bool(nv[k] >= cfg.offset_evaluate)
            out.append(reg.PairRegistration(
                ok=okk,
                offset=(int(dr[k]), int(dc[k])) if okk else (0, 0),
                offset_subpix=(float(dr[k]), float(dc[k])) if okk else (0.0, 0.0),
                direction=cfg.direction if okk else 0,
                scale=0,
                # confidence: floor-zeroed votes (0 = no valid matches)
                confidence=float(nv[k]) if av[k] else 0.0, attempts=1))
    return out


def register_sequence_features(images: np.ndarray, cfg: StitchConfig
                               ) -> List[reg.PairRegistration]:
    """Whole-image feature search for every adjacent pair (non-incremental).

    Each image is detected/described once (cache-parity, see module
    docstring); adjacent pairs are then matched and mode-voted in batch.
    With ``auto_upright`` (default) detection runs with upright descriptors
    first; failed pairs retry with the oriented pipeline over their frames.
    """
    images_dev = jnp.asarray(images)
    n, h, w = images.shape
    if n < 2:
        return []
    _, _, metric = _families(cfg)
    dparams = _detect_params(cfg)
    sparams = _describe_params(cfg)
    max_kp = _capacity(cfg, cfg.features.max_keypoints)

    # detect/describe every image once (lax.map bounds peak HBM per frame)
    emode = _enhance_mode(cfg)
    im = images_dev
    if emode != "none":
        # reference enhances whole images on this path (Stitcher.py:269-276)
        im = enhance.enhance_batch(im, emode == "clahe",
                                   cfg.enhance.clip_limit,
                                   cfg.enhance.tile_size)
    fast = cfg.features.auto_upright and not cfg.features.upright
    sparams_fast = dataclasses.replace(sparams, upright=True) if fast \
        else sparams
    pool = _pool_features_jit(im, max_kp, dparams, sparams_fast)
    out = _match_vote_adjacent(pool, np.arange(n - 1), cfg, metric)
    # same no-consensus skip as the incremental fallback: a pair with ZERO
    # valid upright match displacements (confidence 0, the floor-zeroed
    # count) has nothing for oriented descriptors to rescue; real 1-vote
    # modes ARE retried
    failed = [k for k, r in enumerate(out)
              if not r.ok and r.confidence > 0.0]
    if fast and failed:
        frames = sorted({f for k in failed for f in (k, k + 1)})
        fmap = {f: i for i, f in enumerate(frames)}
        mini = _pool_features_jit(im[jnp.asarray(frames)], max_kp, dparams,
                                  sparams)
        sub = _match_vote_adjacent(mini,
                                   np.asarray([fmap[k] for k in failed]),
                                   cfg, metric)
        for k, r in zip(failed, sub):
            out[k] = r
    return out
