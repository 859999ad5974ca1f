"""Benchmark harness.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., ...extras}

Headline metric: frames/s on the 89-frame dendritic grid through the
FLAGSHIP pipeline, measured from a device-resident batch to HOST-MATERIALIZED
panoramas: incremental-ROI feature registration on the device (the VFSMS
core — the compute-heavy stage), composition host-side in the reference's
own float64 through the threaded C kernels (core/stream_out.compose_host —
zero panorama bytes cross the host<->device link; the same mode
--stream-output selects).  The output is REFERENCE-EXACT arithmetic.
Decode is excluded from the headline (the reference's own phase timers at
Stitcher.py:80-90 exclude it); decode-included numbers are published below.

The frames are the reference's dendritic demo set when it is present, and
otherwise the seeded scan of the same shape (imagestitch_tpu/eval/
seeded_scan.py), written to PNG files so the from-files paths have files.

Extra published numbers:
  * fps_device_compute — device-complete panoramas, no readback.
  * fps_full_readback — end with a FULL-panorama readback instead of the
    rect stream (the non-streamed path).
  * fps_decode_included — end-to-end from image files to host panoramas:
    the host pipeline (io/prefetch.py) overlaps decode of chunk k+1 with
    device work on chunk k (SURVEY §2.3 PP row); output via host
    composition.
  * fps_streamed_rects — device-canvas composition + the visible-piece
    rect stream (core/stream_out.compose_streamed): pixel-exact vs the
    device composer.
  * fps_color_e2e — the reference's ACTUAL dendritic workload (Main.py:6
    isColorMode=True): gray registration + color composition, ONE
    end-to-end pass.  Color composes host-side in the reference's own
    float64 (ops/fusion/host_blend.py).
  * time_to_first_result_s — process start to the first complete stitch
    (cold compile + transfer included): the cold-start accounting.
  * phases — per-phase wall seconds, each ending in block_until_ready,
    plus dispatch counts.  The reference's analog is its register/fuse
    timer split (Stitcher.py:80-90).
  * utilization — modeled device-memory bandwidth achieved by the pooled
    detect/describe stage and modeled FLOP/s of the match matmuls, against
    the card's published peaks (PEAKS, keyed by device_kind).  Models
    count algorithmic bytes/FLOPs (documented in _pool_bytes_model/
    _match_flops), so the numbers are lower bounds on hardware utilization.
"""
import dataclasses
import json
import os
import sys
import time

_T_PROC0 = time.time()

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

DEMO = "/root/reference/demoImages"

#: published peaks per device_kind: (device-memory bytes/s, float32 FLOP/s
#: outside the tensor cores — the match matmuls run at HIGHEST precision).
#: Source: NVIDIA H100 Tensor Core GPU datasheet (SXM5 and PCIe parts).
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),
    "NVIDIA H100 PCIe": (2.0e12, 51e12),
}


def _peaks(device) -> tuple:
    if device.device_kind not in PEAKS:
        raise KeyError(f"no published peaks for {device.device_kind!r}; "
                       f"add them to bench.PEAKS")
    return PEAKS[device.device_kind]


def _dendritic_files(tmp_dir: str):
    """The demo set's files, or the seeded scan written as PNG."""
    from imagestitch_tpu.io import codec, dataset
    demo = os.path.join(DEMO, "dendriticCrystal")
    if os.path.isdir(demo):
        return dataset.list_project_images(demo, 1)
    from imagestitch_tpu.eval import seeded_scan
    frames = seeded_scan.serpentine_scan(0).frames()
    files = []
    for k, f in enumerate(frames):
        files.append(os.path.join(tmp_dir, f"1-{k:03d}.png"))
        codec.imwrite(files[-1], f)
    return files


def _segments(recs, n):
    """All stitchable segments [start, end) (flowStitchWithMutiple split)."""
    segs, start = [], 0
    for k, r in enumerate(recs):
        if not r.ok:
            segs.append((start, k + 1))
            start = k + 1
    segs.append((start, n))
    return segs


def _pool_bytes_model(n: int, h: int, w: int, cfg) -> float:
    """Modeled device-memory bytes of the pooled detect/describe stage.

    Per octave: the DoH response reads the octave image, writes the
    score and raw maps and top-k reads them back; the pyramid atlas is
    written once and read once.  The pool_keypoints global top-K survivors
    then gather (S+2)^2 float patches from the atlas.
    """
    total = 0.0
    ho, wo = h, w
    for o in range(cfg.features.n_octaves):
        if o > 0:
            if min(ho, wo) < 256:
                break
            total += 4.0 * ho * wo * 1.25   # pool2 read + smaller write
            ho, wo = ho // 2, wo // 2
        px = float(ho) * wo
        total += 4.0 * px * (1 + 2 + 1)     # DoH read, score+raw, topk read
        total += 4.0 * px * 2.0             # atlas write + describe read
    total += cfg.features.pool_keypoints * (20 * 20 + 64) * 4.0
    return total * n


def _pool_flops_model(n: int, h: int, w: int, cfg) -> float:
    """Modeled FLOPs of the detect stage's separable convolutions.

    Per scale, 3 response convs x 2 separable passes x (2*radius+1) taps x
    2 flops/MAC per pixel, plus ~20 flops of det/NMS/select overhead per
    pixel.
    """
    import math
    spacing = 2.0 ** (1.0 / max(cfg.features.n_octave_layers, 1))
    per_px = 20.0
    for s in range(cfg.features.n_octave_layers):
        sigma = 1.2 * spacing ** s
        radius = max(2, int(math.ceil(3.0 * sigma)))
        per_px += 3 * 2 * (2 * radius + 1) * 2
    total = 0.0
    ho, wo = h, w
    for o in range(cfg.features.n_octaves):
        if o > 0:
            if min(ho, wo) < 256:
                break
            ho, wo = ho // 2, wo // 2
        total += per_px * ho * wo
    return total * n


def _match_flops(stats) -> float:
    """Modeled FLOPs of the replay's match matmuls: one (K,D)x(D,K)
    contraction per (pair, direction, scale) attempt."""
    k = float(stats.get("k_sel", 0))
    d = float(stats.get("desc_dim", 0))
    return float(stats.get("attempts_matched", 0)) * 2.0 * k * k * d


def main():
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        _main(tmp)


def _main(tmp_dir: str):
    import jax
    from imagestitch_tpu.utils.cache import enable_compilation_cache
    from imagestitch_tpu.utils.profiling import card_info
    enable_compilation_cache()
    device = jax.devices()[0]
    if device.platform != "gpu":
        raise RuntimeError(f"bench needs a GPU; JAX's default device is "
                           f"{device.platform}")
    peak_bytes, peak_flops = _peaks(device)
    card = card_info()
    from imagestitch_tpu import StitchConfig, compose
    from imagestitch_tpu.core import compose as compose_mod
    from imagestitch_tpu.core import feature_registration as freg
    from imagestitch_tpu.core import stream_out
    from imagestitch_tpu.io import dataset, prefetch

    # fixed backend initialization cost: a 1-op probe dispatched before
    # anything else (a cost every jax program pays, independent of this
    # framework or its compile cache)
    import jax.numpy as _jnp
    t0 = time.time()
    np.asarray(jax.jit(lambda: _jnp.zeros((8, 128)).sum())())
    backend_init_s = time.time() - t0

    files = _dendritic_files(tmp_dir)
    n = len(files)
    cfg = StitchConfig(registration="feature_incre", direction=1,
                       direct_incre=1, roi_ratio=0.2, color_mode=False,
                       fuse_method="fadeInAndFadeOut")

    # ---- cold first stitch = time-to-first-result, on the PRODUCTION
    # ingest (io/prefetch.py: worker decode of chunk k+1 ∥ transfer ∥ pool
    # compute of chunk k — the same path the --mesh driver uses), ending in
    # HOST panoramas via the streamed output path (r5: the cold accounting
    # now covers true end-to-end, not device-complete).
    t0 = time.time()
    recs0, gray0, gray0_host = prefetch.register_sequence_pipelined(
        files, cfg, keep_host=True)
    t_cold_ingest_register = time.time() - t0
    t0 = time.time()
    for s, e in _segments(recs0, n):
        if e - s < 2:
            continue
        offs = [recs0[k].offset for k in range(s, e - 1)]
        stream_out.compose_host(gray0_host[s:e], offs, cfg)
    t_cold_compose = time.time() - t0
    t_first_result = time.time() - _T_PROC0
    del gray0, gray0_host, recs0

    t0 = time.time()
    batch = dataset.load_batch(files, color_mode=False)
    t_decode = time.time() - t0
    gray_host = batch.gray
    h, w = gray_host.shape[1:3]

    # ship the dataset to device memory once (the reference re-decodes per
    # pass), in 8-frame (40 MB) chunks
    import jax.numpy as jnp
    t0 = time.time()
    gray = jnp.concatenate([jax.device_put(gray_host[s:s + 8])
                            for s in range(0, n, 8)])
    jax.block_until_ready(gray)
    t_h2d = time.time() - t0

    from imagestitch_tpu.utils.transfer import read_back as _read_back

    def register():
        return freg.register_sequence_features_incre(gray, cfg)

    def stitch_streamed() -> float:
        """Register + compose + streamed host materialization (headline)."""
        t0 = time.time()
        recs = register()
        for s, e in _segments(recs, n):
            if e - s < 2:
                continue
            offs = [recs[k].offset for k in range(s, e - 1)]
            stream_out.compose_streamed(gray_host[s:e], offs, cfg,
                                        frames_dev=gray[s:e])
        return time.time() - t0

    def stitch_device(read_back: bool) -> float:
        """Register + device-complete compose (r1-r4 accounting); with
        ``read_back``, the FULL-panorama readback path."""
        t0 = time.time()
        recs = register()
        outs = []
        for s, e in _segments(recs, n):
            if e - s < 2:
                outs.append(gray[s:e][0])
                continue
            offs = [recs[k].offset for k in range(s, e - 1)]
            outs.append(compose(gray[s:e], offs, cfg, return_device=True))
        jax.block_until_ready(outs)
        if read_back:
            for o in outs:
                _read_back(o)
        return time.time() - t0

    # warm-up the device-resident flagship programs (the cold run above
    # already compiled the shared pool/replay/compose programs)
    stitch_device(read_back=False)

    fps_dev = n / min(stitch_device(read_back=False) for _ in range(3))
    fps_stream = n / min(stitch_streamed() for _ in range(2))
    fps_full_rb = n / stitch_device(read_back=True)

    # decode-included end-to-end (host-composed output)
    def stitch_from_files() -> float:
        t0 = time.time()
        recs, gray_dev, g_host = prefetch.register_sequence_pipelined(
            files, cfg, keep_host=True)
        for s, e in _segments(recs, n):
            if e - s < 2:
                continue
            offs = [recs[k].offset for k in range(s, e - 1)]
            stream_out.compose_host(g_host[s:e], offs, cfg)
        return time.time() - t0

    fps_dec = n / min(stitch_from_files() for _ in range(2))

    # zero-readback gray mode: device registers, the host composes in the
    # reference's float64 through the native C kernels (compose_host) —
    # no panorama bytes cross the link at all.  Published alongside the
    # streamed headline; output is reference-exact (the device f32
    # composer agrees to ±1 LSB on a tiny blended fraction).
    def stitch_host_compose() -> float:
        t0 = time.time()
        recs = register()
        for s, e in _segments(recs, n):
            if e - s < 2:
                continue
            offs = [recs[k].offset for k in range(s, e - 1)]
            stream_out.compose_host(gray_host[s:e], offs, cfg)
        return time.time() - t0

    fps_host = n / min(stitch_host_compose() for _ in range(3))

    # ---- warm per-phase decomposition (each phase ends in
    # block_until_ready; min of 3 passes) ----
    fast = cfg.features.auto_upright and not cfg.features.upright
    cfg_pool = cfg.replace(features=dataclasses.replace(
        cfg.features, upright=True)) if fast else cfg
    t_pool = t_replay = t_fallback = t_compose = float("inf")
    t_rects = t_paste = float("inf")
    for _ in range(3):
        t0 = time.time()
        pool = jax.block_until_ready(freg._precompute_pool(gray, cfg_pool))
        t_pool = min(t_pool, time.time() - t0)
        t0 = time.time()
        recs = freg.replay_from_pool(pool, n, (h, w), cfg_pool)
        t_replay = min(t_replay, time.time() - t0)
        replay_stats = dict(freg.LAST_REPLAY_STATS)
        t0 = time.time()
        if fast and any(not r.ok for r in recs):
            recs = freg._oriented_fallback_incre(gray, recs, cfg, (h, w))
        t_fallback = min(t_fallback, time.time() - t0)
        # device compose
        outs = []
        t0 = time.time()
        seg_plans = []
        for s, e in _segments(recs, n):
            if e - s < 2:
                continue
            offs = [recs[k].offset for k in range(s, e - 1)]
            placement, steps, _ = compose_mod.plan_compose(offs, (h, w), cfg)
            seg_plans.append((s, e, offs, placement, steps))
            outs.append(compose(gray[s:e], offs, cfg, return_device=True))
        jax.block_until_ready(outs)
        t_compose = min(t_compose, time.time() - t0)
        # visible-piece extraction + stream readback
        t0 = time.time()
        streams = []
        for (s, e, offs, placement, steps), pano in zip(seg_plans, outs):
            rects = stream_out.visible_rect_pieces(steps, (h, w))
            streams.append((rects, _read_back(
                stream_out._extract_rects_flat(pano, rects))))
        t_rects = min(t_rects, time.time() - t0)
        stream_mb = sum(st.nbytes for _, st in streams) / 1e6
        # host paste + patch
        t0 = time.time()
        for (s, e, offs, placement, steps), (rects, st) in zip(seg_plans,
                                                               streams):
            canvas = stream_out.paste_all_host(gray_host[s:e], placement,
                                               steps)
            stream_out.patch_rects_host(canvas, rects, st)
        t_paste = min(t_paste, time.time() - t0)

    pool_bytes = _pool_bytes_model(n, h, w, cfg_pool)
    match_fl = _match_flops(replay_stats)

    # ---- COLOR end-to-end: the reference's dendritic workload (Main.py
    # isColorMode=True: register gray, compose color) in ONE pass —
    # device gray registration + host float64 color composition
    # (core/stream_out.compose_color_host).  Color decode
    # is timed separately (the reference re-decodes color at composition,
    # Stitcher.py:381-384).
    t0 = time.time()
    batch_c = dataset.load_batch(files, color_mode=True)
    t_decode_color = time.time() - t0
    cfg_color = cfg.replace(color_mode=True)
    t_color_e2e = float("inf")
    for _ in range(2):
        t0 = time.time()
        recs_c = register()
        for s, e in _segments(recs_c, n):
            if e - s < 2:
                continue
            offs = [recs_c[k].offset for k in range(s, e - 1)]
            stream_out.compose_color_host(batch_c.color[s:e], offs,
                                          cfg_color)
        t_color_e2e = min(t_color_e2e, time.time() - t0)
    fps_color = n / t_color_e2e
    del batch_c

    print(json.dumps({
        "metric": "dendritic 89-frame flagship stitch, all segments, "
                  "END-TO-END to host panoramas (device feature "
                  "registration + reference-f64 host composition)",
        "value": round(fps_host, 3),
        "unit": "frames/s",
        "device": {"platform": device.platform, "kind": device.device_kind,
                   "count": len(jax.devices()), "card": card},
        "fps_device_compute": round(fps_dev, 3),
        # non-streamed path: full-panorama readback
        "fps_full_readback": round(fps_full_rb, 3),
        "fps_decode_included": round(fps_dec, 3),
        # device-canvas + visible-piece rect stream (device-exact output)
        "fps_streamed_rects": round(fps_stream, 3),
        # the reference's own dendritic workload: register gray, compose
        # COLOR — one end-to-end pass, host f64 composition
        "fps_color_e2e": round(fps_color, 3),
        "time_to_first_result_s": round(t_first_result, 1),
        "cold_path": "pipelined_ingest_first_stitch_host_composed",
        "backend_init_s": round(backend_init_s, 1),
        "cold_start_minus_backend_init_s": round(
            t_first_result - backend_init_s, 1),
        # cold split: ingest+register = decode ∥ H2D ∥ pool compile
        # (AOT-warmed in a background thread) + replay compile; compose =
        # host f64 composition (no device compile)
        "cold_ingest_register_s": round(t_cold_ingest_register, 1),
        "cold_compose_s": round(t_cold_compose, 1),
        "phases": {
            "decode_s": round(t_decode, 3),
            "decode_color_s": round(t_decode_color, 3),
            "h2d_s": round(t_h2d, 3),
            "register_pool_s": round(t_pool, 3),
            "register_replay_s": round(t_replay, 3),
            "register_fallback_s": round(t_fallback, 3),
            "compose_s": round(t_compose, 3),
            "rect_stream_s": round(t_rects, 3),
            "rect_stream_mb": round(stream_mb, 1),
            "host_assemble_s": round(t_paste, 3),
            "color_host_compose_s": round(t_color_e2e - t_pool - t_replay
                                          - t_fallback, 3),
            "replay_dispatches": replay_stats.get("dispatches"),
            "replay_attempts_matched": replay_stats.get("attempts_matched"),
        },
        "utilization": {
            "pool_modeled_gb": round(pool_bytes / 1e9, 2),
            "pool_gbps": round(pool_bytes / t_pool / 1e9, 1),
            "pool_mem_util": round(pool_bytes / t_pool / peak_bytes, 3),
            "pool_conv_modeled_gflop": round(
                _pool_flops_model(n, h, w, cfg_pool) / 1e9, 1),
            "pool_conv_gflops": round(
                _pool_flops_model(n, h, w, cfg_pool) / t_pool / 1e9, 1),
            "match_modeled_gflop": round(match_fl / 1e9, 1),
            "match_tflops": round(match_fl / t_replay / 1e12, 2),
            "match_fp32_util": round(match_fl / t_replay / peak_flops, 4),
            "peaks": {"bytes_per_s": peak_bytes, "fp32_flops": peak_flops},
        },
    }))


if __name__ == "__main__":
    main()
