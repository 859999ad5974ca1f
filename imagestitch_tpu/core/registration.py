"""Incremental-ROI registration drivers.

The reference evaluates registration attempts one at a time on the host,
rotating the search direction and growing the ROI until a confident match
(reference: Stitcher.py:205-258 for the phase path, :306-367 for the feature
path), persisting the successful direction across pairs (Stitcher.py:361).

Batched redesign: attempts are evaluated for the WHOLE pair batch in one
device dispatch per (direction, scale) configuration — at most
``4 * max_scale`` dispatches per sequence instead of one host round trip per
attempt — and the reference's sequential decision procedure is replayed
exactly on the host over the precomputed scalar results.  The replay is
bit-identical to the serial algorithm because each attempt's outcome depends
only on (pair, direction, scale), never on the outcome of other attempts.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import StitchConfig, direction_increase, max_roi_scale
from ..ops import phase_corr, roi


@dataclasses.dataclass
class PairRegistration:
    """Structured per-pair record (SURVEY §5: observability upgrade)."""
    ok: bool
    offset: Tuple[int, int]            # (drow, dcol) — reference's [dx, dy]
    offset_subpix: Tuple[float, float]  # sub-pixel offset for the global solver
    direction: int                     # direction that matched (0 if failed)
    scale: int                         # ROI scale i that matched (0 if failed)
    confidence: float                  # phase response / modal vote count
    attempts: int                      # number of attempts consumed


def bucket_size(n: int) -> int:
    """Round a subset size up to a power of two so every (config, bucket)
    pair compiles at most once."""
    b = 1
    while b < n:
        b *= 2
    return b


class AttemptCache:
    """Lazily-materialized (direction, scale, pair) attempt results.

    ``evaluator(direction, ratio, pair_indices)`` evaluates one configuration
    for an explicit subset of pairs in a single batched dispatch and returns
    host arrays aligned with ``pair_indices``.  When the replay demands a
    missing (config, pair) result, the whole set of still-unresolved pairs is
    prefetched speculatively in the same dispatch — the sequential semantics
    stay exact (an attempt's outcome depends only on (pair, direction,
    scale)), while resolved pairs stop consuming device time.
    """

    def __init__(self, evaluator: Callable[[int, float, np.ndarray],
                                           Dict[str, np.ndarray]]):
        self._evaluator = evaluator
        self._cache: Dict[Tuple[int, int], Dict[int, Dict[str, float]]] = {}
        self.dispatches = 0
        self.pairs_evaluated: set = set()

    def get(self, direction: int, scale: int, ratio: float, pair: int,
            prefetch: Sequence[int]) -> Dict[str, float]:
        key = (direction, scale)
        store = self._cache.setdefault(key, {})
        if pair not in store:
            todo = [pair] + [p for p in prefetch if p != pair and p not in store]
            idx = np.asarray(sorted(todo), np.int32)
            res = self._evaluator(direction, scale * ratio, idx)
            self.dispatches += 1
            self.pairs_evaluated.update(int(p) for p in idx)
            for j, p in enumerate(idx):
                store[int(p)] = {k: v[j] for k, v in res.items()}
        return store[pair]


def _replay_incremental(num_pairs: int, cfg: StitchConfig,
                        cache: AttemptCache,
                        accept: Callable[[Dict[str, float]], bool],
                        extract: Callable[[Dict[str, float]],
                                          Tuple[float, float, float]],
                        shape: Tuple[int, int],
                        offsets_are_full: bool = False,
                        pairs: Optional[Sequence[int]] = None
                        ) -> List[PairRegistration]:
    """Replay the reference's scale-growth x direction-rotation search.

    ``accept(result)`` decides whether an attempt succeeded for a pair;
    ``extract`` returns (drow_f, dcol_f, confidence).  Exact semantics of
    Stitcher.py:205-258 / :306-367 including direction persistence across
    pairs.  ``offsets_are_full``: the evaluator already reports full-image
    offsets (pooled feature path) — skip the strip margin correction (the
    two formulations are algebraically identical: strip offset + margin ==
    full-image displacement, since the strip origins are integer).
    ``pairs``: optional explicit pair subset to replay (the hybrid fallback
    re-registers only failed pairs); results align with ``pairs`` order and
    direction persists across the iterated subset.
    """
    out: List[PairRegistration] = []
    direction = cfg.direction
    max_i = max_roi_scale(cfg.roi_ratio)
    pair_list = list(range(num_pairs)) if pairs is None else list(pairs)
    for ki, k in enumerate(pair_list):
        ini_direction = direction
        local_direction = ini_direction
        status = False
        attempts = 0
        best = None
        best_conf = 0.0   # max confidence seen across FAILED attempts
        # the replay decides pairs strictly in order, so at pair k the
        # actually-unresolved set is exactly the remaining iterated pairs;
        # the cache skips members already evaluated at this (dir, scale)
        unresolved = pair_list[ki:]
        for i in range(1, max_i):
            while True:
                # scale-1 configs are what later pairs will mostly need;
                # deeper scales are rare — prefetch narrowly there
                pf = unresolved if i == 1 else list(unresolved)[:8]
                res = cache.get(local_direction, i, cfg.roi_ratio, k,
                                prefetch=pf)
                attempts += 1
                if accept(res):
                    status = True
                    best = (local_direction, i, extract(res))
                else:
                    best_conf = max(best_conf, extract(res)[2])
                if status:
                    break
                local_direction = direction_increase(local_direction, cfg.direct_incre)
                if local_direction == ini_direction:
                    break
            if status:
                break
        if status:
            d, i, (drow_f, dcol_f, conf) = best
            if offsets_are_full:
                mr = mc = 0
            else:
                mr, mc = roi.margin_correction(d, shape, shape,
                                               i * cfg.roi_ratio)
            # reference truncates the sub-pixel strip offset BEFORE the margin
            # correction (Stitcher.py:231-232 then :243-253)
            drow = int(drow_f) + mr
            dcol = int(dcol_f) + mc
            direction = d
            out.append(PairRegistration(
                ok=True, offset=(drow, dcol),
                offset_subpix=(drow_f + mr, dcol_f + mc),
                direction=d, scale=i, confidence=conf, attempts=attempts))
        else:
            # failed records carry the MAX confidence any attempt reached
            # (max modal votes / max phase response): downstream retry
            # policies use it to tell "weak consensus" from "no consensus
            # anywhere" (the permanently-unstitchable missing-frame pair)
            out.append(PairRegistration(
                ok=False, offset=(0, 0), offset_subpix=(0.0, 0.0),
                direction=0, scale=0, confidence=best_conf,
                attempts=attempts))
    return out


# --------------------------------------------------------------------------
# Phase-correlation incremental registrar (reference Stitcher.py:205-258)
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("direction", "ratio", "hp", "wp"))
def _phase_attempt_jit(images: jnp.ndarray, idx: jnp.ndarray, direction: int,
                       ratio: float, hp: int, wp: int):
    """Selected pairs' strips for one (direction, ratio) -> phase correlation.

    ``images``: (N, H, W) uint8 device batch; ``idx``: (B,) pair indices
    (pair k = images k, k+1).  Gather + slice + cast + FFT fuse into one XLA
    program; nothing round-trips.
    """
    a = images[idx]
    b = images[idx + 1]
    ra, rb = roi.extract_strips(a, b, direction, ratio)
    f = jax.vmap(lambda x, y: phase_corr._phase_correlate_one(
        x.astype(jnp.float32), y.astype(jnp.float32), hp, wp))
    return f(ra, rb)


def pad_indices(idx: np.ndarray) -> Tuple[np.ndarray, int]:
    """Pad a subset-index vector to its power-of-two bucket (repeat last)."""
    n = len(idx)
    b = bucket_size(n)
    if b == n:
        return idx, n
    return np.concatenate([idx, np.full(b - n, idx[-1], idx.dtype)]), n


# Introspection for tests/harnesses: dispatch + pair-subset accounting of the
# most recent register_sequence_phase call (e.g. the hybrid fallback must only
# evaluate the failed pairs, not re-sweep the sequence).
LAST_PHASE_STATS: Dict[str, object] = {}


def register_sequence_phase(images: np.ndarray, cfg: StitchConfig,
                            pairs: Optional[Sequence[int]] = None
                            ) -> List[PairRegistration]:
    """Incremental phase-correlation registration of a full sequence.

    ``images``: (N, H, W) uint8 grayscale batch (host or device).
    Replaces the reference's per-pair, per-attempt cv2.phaseCorrelate loop.
    ``pairs``: optional explicit subset of pair indices to register (results
    align with ``pairs``); used by the hybrid fallback so one failed pair
    costs one-pair dispatches, not a full-sequence sweep.
    """
    images_dev = jnp.asarray(images)
    n, h, w = images.shape
    if n < 2:
        return []

    def evaluator(direction: int, ratio: float, idx: np.ndarray
                  ) -> Dict[str, np.ndarray]:
        if direction in (1, 3):
            sh, sw = roi.strip_length(h, ratio), w
        else:
            sh, sw = h, roi.strip_length(w, ratio)
        hp, wp = phase_corr.optimal_dft_size(sh), phase_corr.optimal_dft_size(sw)
        idx_p, keep = pad_indices(idx)
        sx, sy, resp = _phase_attempt_jit(images_dev, jnp.asarray(idx_p),
                                          direction, ratio, hp, wp)
        return {"sx": np.asarray(sx)[:keep], "sy": np.asarray(sy)[:keep],
                "resp": np.asarray(resp)[:keep]}

    cache = AttemptCache(evaluator)

    def accept(res: Dict[str, float]) -> bool:
        return bool(res["resp"] > cfg.phase_response_threshold)

    def extract(res: Dict[str, float]) -> Tuple[float, float, float]:
        # cv2.phaseCorrelate returns (x, y) = the NEGATIVE of the window
        # displacement of B relative to A, so the strip-local offset the
        # margin correction expects is (-y, -x).  The reference adds +y/+x
        # (Stitcher.py:231-232) — a sign inversion that makes its phase path
        # compute 2*margin - offset; that path is explicitly marked
        # incomplete (Stitcher.py:207) and unused by its driver.  We repair
        # rather than replicate.  Truncation commutes with negation
        # (int() truncates toward zero), preserving the int semantics.
        return -float(res["sy"]), -float(res["sx"]), float(res["resp"])

    out = _replay_incremental(n - 1, cfg, cache, accept, extract, (h, w),
                              pairs=pairs)
    LAST_PHASE_STATS.clear()
    LAST_PHASE_STATS.update(dispatches=cache.dispatches,
                            pairs_evaluated=sorted(cache.pairs_evaluated))
    return out


@functools.partial(jax.jit, static_argnames=("hp", "wp"))
def _phase_whole_jit(images: jnp.ndarray, hp: int, wp: int):
    """All adjacent pairs, whole-image linear phase correlation.

    Mean subtraction before zero-padding removes the content->pad step edge
    shared by both images (a broadband artifact that otherwise correlates at
    exactly zero shift and beats small-overlap true peaks); the response is
    renormalized from padded area to true image area so the acceptance
    threshold keeps cv2's scale.
    """
    x = images.astype(jnp.float32)
    x = x - jnp.mean(x, axis=(1, 2), keepdims=True)
    # lax.map bounds peak HBM to ONE pair's padded FFT temporaries (~2 GB at
    # 2.6k x 2k frames); vmap over all pairs would materialize them all
    sx, sy, resp = jax.lax.map(
        lambda uv: phase_corr._phase_correlate_one(uv[0], uv[1], hp, wp),
        (x[:-1], x[1:]))
    h, w = images.shape[1], images.shape[2]
    return sx, sy, resp * (float(hp) * wp / (h * w))


def register_sequence_phase_whole(images: np.ndarray, cfg: StitchConfig,
                                  mesh=None) -> List[PairRegistration]:
    """Whole-image phase correlation for all pairs in one dispatch.

    Working replacement for the reference's vestigial
    ``calculateOffsetForPhaseCorrleate`` (Stitcher.py:184-203), whose
    ``self.phase`` GPU-FFT module is missing: offset = [round(y), round(x)]
    per its intended semantics (Stitcher.py:198-199).

    Design repairs vs. cv2.phaseCorrelate (this path exists for LARGE
    shifts, which cv2's defaults cannot represent):
      * pad to >= 2*dim — padding only to the optimal DFT size >= dim makes
        the correlation circular, so any shift beyond half the padded size
        aliases (iron's 1698-row shift would wrap to ~-246); 2x padding is
        the full linear cross-correlation, unambiguous for every physically
        possible offset;
      * mean-subtract before padding and renormalize the response (see
        ``_phase_whole_jit``).
    """
    n, h, w = images.shape
    if n < 2:
        return []
    hp = phase_corr.optimal_dft_size(2 * h)
    wp = phase_corr.optimal_dft_size(2 * w)
    working = 6 * hp * wp * 8   # padded complex64 surfaces (tp_fft's model)
    if mesh is not None and mesh.devices.size > 1 \
            and working > cfg.phase_hbm_budget:
        # over-budget strip: the tensor-parallel transpose-decomposed FFT —
        # no device ever materializes the full padded surface
        from ..parallel import tp_fft
        host = np.asarray(images).astype(np.float32)
        host = host - host.mean(axis=(1, 2), keepdims=True)
        out: List[PairRegistration] = []
        for k in range(n - 1):
            sxk, syk, rk = tp_fft.phase_correlate_sharded(
                host[k], host[k + 1], mesh, hp, wp)
            rk *= float(hp) * wp / (h * w)
            ok = bool(rk > cfg.phase_response_threshold)
            out.append(PairRegistration(
                ok=ok, offset=(int(np.round(-syk)), int(np.round(-sxk))),
                offset_subpix=(float(-syk), float(-sxk)),
                direction=cfg.direction if ok else 0,
                scale=0, confidence=float(rk), attempts=1))
        return out
    images_dev = jnp.asarray(images)
    sx, sy, resp = _phase_whole_jit(images_dev, hp, wp)
    sx, sy, resp = np.asarray(sx), np.asarray(sy), np.asarray(resp)
    out: List[PairRegistration] = []
    for k in range(n - 1):
        ok = bool(resp[k] > cfg.phase_response_threshold)
        # negate: cv2's (x, y) is minus the B-relative-to-A displacement
        out.append(PairRegistration(
            ok=ok,
            offset=(int(np.round(-sy[k])), int(np.round(-sx[k]))),
            offset_subpix=(float(-sy[k]), float(-sx[k])),
            direction=cfg.direction if ok else 0,
            scale=0, confidence=float(resp[k]), attempts=1))
    return out


def register_sequence_hybrid(images: np.ndarray, cfg: StitchConfig
                             ) -> List[PairRegistration]:
    """Feature registration with per-pair phase-correlation fallback.

    New capability (no reference analog): feature voting fails on sparse
    -texture pairs where whole-strip phase correlation still locks (and vice
    versa on periodic textures where phase aliases but features vote
    reliably).  Feature results win when confident; phase fills the gaps —
    strictly fewer segment breaks than either path alone (demo: zirconTEM
    registers 8/8 hybrid vs 7/8 feature-only).
    """
    from . import feature_registration
    feat = feature_registration.register_sequence_features_incre(images, cfg)
    failed = [k for k, r in enumerate(feat) if not r.ok]
    if not failed:
        return feat
    # fallback evaluates ONLY the failed pairs (subset dispatch); the phase
    # search starts from the direction the last successful feature pair
    # before the first failure established, mirroring the replay's
    # direction-persistence semantics
    direction = cfg.direction
    for k in range(failed[0] - 1, -1, -1):
        if feat[k].ok and feat[k].direction:
            direction = feat[k].direction
            break
    phase = register_sequence_phase(images, cfg.replace(direction=direction),
                                    pairs=failed)
    out = list(feat)
    for k, p in zip(failed, phase):
        out[k] = p
    return out


# --------------------------------------------------------------------------
# Feature-search registrars (reference Stitcher.py:260-367) — implemented in
# features.py's batched detect/describe/match/vote stack.
# --------------------------------------------------------------------------

def register_sequence_features_incre(images: np.ndarray, cfg: StitchConfig
                                     ) -> List[PairRegistration]:
    from . import feature_registration
    return feature_registration.register_sequence_features_incre(images, cfg)


def register_sequence_features(images: np.ndarray, cfg: StitchConfig
                               ) -> List[PairRegistration]:
    from . import feature_registration
    return feature_registration.register_sequence_features(images, cfg)
