"""Host pipeline parallelism: decode ∥ transfer ∥ device compute.

The reference's stage chain (decode -> register -> fuse, timed separately at
Stitcher.py:61-90) is strictly serial.  Here the three stages overlap
(SURVEY §2.3 PP row): a worker thread decodes chunk k+1 while chunk k's
host->device transfer and pooled feature extraction run — JAX dispatch is
asynchronous, so issuing the chunk's pool computation returns immediately
and the device crunches while libjpeg decodes the next chunk.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import dataset


class ChunkPrefetcher:
    """One-chunk-lookahead decoded-batch iterator (double buffering).

    Yields ``ImageBatch`` chunks of ``chunk_frames`` files; while the caller
    processes chunk k, the worker thread is already decoding chunk k+1.
    """

    def __init__(self, files: Sequence[str], color_mode: bool = False,
                 chunk_frames: int = 16):
        self._files = list(files)
        self._color = color_mode
        self._chunk = max(chunk_frames, 2)
        self._pool = ThreadPoolExecutor(max_workers=1)

    def __iter__(self) -> Iterator[dataset.ImageBatch]:
        spans = [(s, min(s + self._chunk, len(self._files)))
                 for s in range(0, len(self._files), self._chunk)]
        fut = self._pool.submit(dataset.load_batch,
                                self._files[spans[0][0]:spans[0][1]],
                                self._color)
        for k in range(len(spans)):
            batch = fut.result()
            if k + 1 < len(spans):
                s, e = spans[k + 1]
                fut = self._pool.submit(dataset.load_batch,
                                        self._files[s:e], self._color)
            yield batch


def pooled_features_pipelined(files: Sequence[str], cfg,
                              chunk_frames: int = 16,
                              keep_host: bool = False
                              ) -> Tuple[tuple, jnp.ndarray,
                                         Optional[np.ndarray]]:
    """Decode-overlapped pooled feature extraction for a whole sequence.

    Returns ``(pool, gray_dev, gray_host)``: the (rows, cols, scores, descs)
    keypoint pool for every frame and the device-resident grayscale batch
    (kept for composition); ``gray_host`` is the decoded host batch when
    ``keep_host`` (streamed-output assembly input), else None.  Equivalent
    to ``load_batch`` + ``_precompute_pool`` but with
    decode(k+1) ∥ transfer(k) ∥ pool-compute(k).
    """
    from ..core import feature_registration as freg

    # cold-start overlap: AOT-compile the LATE
    # programs — the tail-chunk pool and the replay's first attempt sweep —
    # while the main-chunk pool compiles on the dispatch path and the
    # chunks decode/upload.  (Warming the main chunk's own program is
    # counterproductive: its first dispatch happens within seconds and the
    # two compilations would just contend for the compiler.)
    _warm_pool_programs_async(files, cfg, chunk_frames)

    dev_chunks: List[jnp.ndarray] = []
    host_chunks: List[np.ndarray] = []
    pools = []
    for batch in ChunkPrefetcher(files, color_mode=False,
                                 chunk_frames=chunk_frames):
        dev = jax.device_put(batch.gray)
        # async dispatch: returns immediately, device computes while the
        # prefetcher thread decodes the next chunk
        pools.append(freg._precompute_pool(dev, cfg))
        dev_chunks.append(dev)
        if keep_host:
            host_chunks.append(batch.gray)
    gray_dev = jnp.concatenate(dev_chunks) if len(dev_chunks) > 1 \
        else dev_chunks[0]
    pool = tuple(jnp.concatenate([p[i] for p in pools])
                 for i in range(len(pools[0])))
    gray_host = None
    if keep_host:
        gray_host = np.concatenate(host_chunks) if len(host_chunks) > 1 \
            else host_chunks[0]
    return pool, gray_dev, gray_host


def _warm_pool_programs_async(files: Sequence[str], cfg,
                              chunk_frames: int):
    """Fire-and-forget (daemon) AOT compile of the late-dispatched
    programs: the tail-chunk pool and the replay's first attempt sweep.
    XLA compiles release the GIL, so this genuinely overlaps libjpeg
    decode, H2D, and the main chunk's dispatch-path compile; results reach
    the dispatch path through the persistent compilation cache."""
    import jax

    from ..core import feature_registration as freg
    from . import native_loader

    shape = native_loader.probe_dims(files[0]) if files else None
    if shape is None:
        return None
    n = len(files)
    chunk = max(chunk_frames, 2)
    lengths = set()
    if n > chunk and n % chunk:
        lengths.add(n % chunk)      # the tail chunk dispatches LAST

    def work():
        # the replay sweep first: its compile can hide entirely inside the
        # window where the MAIN chunk's pool compiles on the dispatch path
        _warm_replay(files, cfg, shape, n)
        for ln in sorted(lengths):
            try:
                struct = jax.ShapeDtypeStruct((ln,) + shape, jnp.uint8)
                freg._pool_features_jit.lower(
                    struct, freg._capacity(cfg, cfg.features.pool_keypoints),
                    freg._detect_params(cfg),
                    freg._describe_params(cfg)).compile()
            except Exception:
                return   # warmup is best-effort; the real call compiles

    import threading
    t = threading.Thread(target=work, daemon=True)
    t.start()
    return t


def _warm_replay(files, cfg, shape, n):
    """AOT-compile the replay's first big attempt sweep (all four
    directions of scale 1, full-pair bucket) — its shapes are fully
    determined by (n, frame shape, config), and it otherwise serializes
    its compile behind the replay's first dispatch."""
    import jax

    from ..core import feature_registration as freg

    try:
        from ..core import registration as reg
        from ..ops.features import describe as desc_mod
        if n < 2:
            return
        bucket = reg.bucket_size(n - 1)
        p_cap = freg._capacity(cfg, cfg.features.pool_keypoints)
        k_sel = freg._capacity(cfg, cfg.features.max_keypoints)
        sparams = freg._describe_params(cfg)
        dim = desc_mod.descriptor_dim(sparams)
        _, _, metric = freg._families(cfg)
        h, w = shape
        configs = [(cfg.direction, 1)] + [
            (d, 1) for d in (1, 2, 3, 4) if d != cfg.direction]
        bounds = tuple(
            (freg._strip_bounds(d, "first", s * cfg.roi_ratio, h, w),
             freg._strip_bounds(d, "second", s * cfg.roi_ratio, h, w))
            for d, s in configs)
        f32 = jnp.float32
        freg._pool_attempt_multi_jit.lower(
            jax.ShapeDtypeStruct((n, p_cap), f32),
            jax.ShapeDtypeStruct((n, p_cap), f32),
            jax.ShapeDtypeStruct((n, p_cap), f32),
            jax.ShapeDtypeStruct((n, p_cap, dim), f32),
            jax.ShapeDtypeStruct((bucket,), jnp.int32),
            bounds, k_sel, metric,
            # weak_type: the real call passes python floats, which
            # trace weakly typed — a strong-f32 struct would compile a
            # cache entry the runtime call never hits
            jax.ShapeDtypeStruct((), f32, weak_type=True),
            jax.ShapeDtypeStruct((), f32, weak_type=True),
            cfg.offset_calculate).compile()
    except Exception:
        pass   # warmup is best-effort; the real call compiles


def load_batch_pipelined(files: Sequence[str], color_mode: bool,
                         to_device: bool = True, chunk_frames: int = 16
                         ) -> dataset.ImageBatch:
    """``dataset.load_batch`` with decode(k+1) ∥ transfer(k) overlap.

    With ``to_device`` the returned ``gray`` is a device-resident jnp array
    (each chunk's host->device transfer overlaps the next chunk's libjpeg
    decode); color frames (composition input) stay host-side.
    ``to_device=False`` (mesh mode) keeps everything host-side so the
    sharded registration can place frames with its own NamedSharding.
    """
    gray_chunks: List = []
    color_chunks: List[np.ndarray] = []
    all_files: List[str] = []
    for batch in ChunkPrefetcher(files, color_mode=color_mode,
                                 chunk_frames=chunk_frames):
        g = jax.device_put(batch.gray) if to_device else batch.gray
        gray_chunks.append(g)
        if color_mode:
            color_chunks.append(batch.color)
        all_files.extend(batch.files)
    gray = (jnp.concatenate(gray_chunks) if to_device
            else np.concatenate(gray_chunks)) \
        if len(gray_chunks) > 1 else gray_chunks[0]
    color = None
    if color_mode:
        color = np.concatenate(color_chunks) if len(color_chunks) > 1 \
            else color_chunks[0]
    return dataset.ImageBatch(gray=gray, color=color, files=all_files)


def register_sequence_pipelined(files: Sequence[str], cfg,
                                chunk_frames: int = 16,
                                keep_host: bool = False):
    """End-to-end decode-included registration of a file sequence.

    Returns ``(records, gray_dev, gray_host)`` — feature_incre pooled-path
    records (identical to register_sequence_features_incre on the decoded
    batch; detection is per-frame, so chunking changes nothing) plus the
    device-resident grayscale frames; ``gray_host`` is the host batch when
    ``keep_host`` (for streamed-output assembly), else None.
    """
    import dataclasses

    from ..core import feature_registration as freg

    fast = cfg.features.auto_upright and not cfg.features.upright
    cfg_pool = cfg.replace(features=dataclasses.replace(
        cfg.features, upright=True)) if fast else cfg
    pool, gray_dev, gray_host = pooled_features_pipelined(
        files, cfg_pool, chunk_frames, keep_host=keep_host)
    n, h, w = gray_dev.shape
    recs = freg.replay_from_pool(pool, n, (h, w), cfg_pool)
    if fast and any(not r.ok for r in recs):
        recs = freg._oriented_fallback_incre(gray_dev, recs, cfg, (h, w))
    return recs, gray_dev, gray_host
