"""Smoke test of the stitcher on an NVIDIA GPU.

Runs the main path once, at full frame size, on seeded data
(``imagestitch_tpu/eval/seeded_scan.py``) and checks every result:

  0. device: a GPU is JAX's default device; host decoders and the native
     runtime are reported;
  1. the 89-frame flagship (feature_incre, direction 1, direct_incre 1,
     roi 0.2, fade, gray) through ``Stitcher.stitch_batch``: one segment,
     every offset within 1 px of the true geometry, the panorama of the
     true extent with each frame's interior pasted verbatim;
     then the detect/describe pool alone: ms/frame and its top device
     operations from a profiler trace;
  2. the first 8 frames through the same ``Stitcher`` on the CPU device:
     identical offsets, panorama within 1 LSB on at most 1e-4 of pixels;
  3. phase correlation (the iron configuration) on a seeded pair with a
     known offset, on the GPU and the CPU;
  4. the CLI from PNG files, in this process: its panorama equals the
     library's over the same frames within the phase-2 bound.

``--devices 4`` runs only the flagship over a 4-device frame mesh against
one device.  The last line of standard output is one JSON object; any
failed check raises and ends the run with a non-zero exit code.

    python chip_smoke.py [--seed N] [--devices 4]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

#: panorama bound of README "known divergences": device fusion is float32
#: where the reference (and XLA:CPU scheduling) rounds differently, so a
#: blended pixel may differ by 1 LSB, on a tiny share of pixels
MAX_LSB = 1
MAX_DIFF_SHARE = 1e-4


def flagship_config():
    """The dendritic demo run (reference Main.py:17-51), composed gray."""
    from imagestitch_tpu import StitchConfig
    return StitchConfig(registration="feature_incre", direction=1,
                        direct_incre=1, roi_ratio=0.2, color_mode=False,
                        fuse_method="fadeInAndFadeOut")


def iron_config():
    """The iron demo run (README quick start), composed gray."""
    from imagestitch_tpu import StitchConfig
    return StitchConfig(registration="phase_incre", direction=1,
                        direct_incre=0, roi_ratio=0.2, color_mode=False)


def check_platform(devices) -> None:
    """Fail unless JAX's default device is a GPU."""
    if devices[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's default device is "
                           f"{devices[0].platform} ({devices[0]})")


def stitch(frames: np.ndarray, cfg, device=None, mesh=None):
    """Stitch a gray batch through the library entry point, on ``device``
    (JAX's default when None) or over ``mesh``."""
    import contextlib

    import jax
    from imagestitch_tpu import Stitcher
    from imagestitch_tpu.io.dataset import ImageBatch
    batch = ImageBatch(gray=frames, color=None,
                       files=[f"frame-{k:03d}" for k in range(len(frames))])
    ctx = jax.default_device(device) if device is not None \
        else contextlib.nullcontext()
    with ctx:
        res = Stitcher(cfg, mesh=mesh).stitch_batch(batch)
    return jax.block_until_ready(res)


def compare_panoramas(a: np.ndarray, b: np.ndarray, what: str):
    """Check ``a`` and ``b`` agree within the fade bound; returns
    (max difference, share of differing pixels)."""
    if a.shape != b.shape:
        raise AssertionError(f"{what}: panorama shapes {a.shape} vs {b.shape}")
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    mx, share = int(diff.max()), float(np.mean(diff > 0))
    print(f"{what}: max |diff| {mx} LSB, {share:.3e} of pixels differ")
    if mx > MAX_LSB or share > MAX_DIFF_SHARE:
        raise AssertionError(f"{what}: panoramas differ beyond {MAX_LSB} LSB "
                             f"on {MAX_DIFF_SHARE} of pixels")
    return mx, share


def check_flagship(res, scan, frames: np.ndarray, margin: int) -> None:
    """One segment, offsets within 1 px of the truth, the true extent, and
    every frame's interior (``margin`` px in from each edge, clear of all
    overlaps) pasted verbatim."""
    from imagestitch_tpu.core.compose import compute_placement
    if len(res) != 1:
        raise AssertionError(f"{len(res)} segments, expected 1: "
                             f"{[r.file_range for r in res]}")
    offs = np.asarray(res[0].offsets, np.int64)
    truth = scan.true_offsets[:len(frames) - 1]
    err = np.abs(offs - truth)
    exact = int(np.sum(np.all(offs == scan.expected_offsets[:len(offs)],
                              axis=1)))
    print(f"offsets: {len(offs)} pairs, max |offset - truth| "
          f"{float(err.max()):.1f} px, {exact}/{len(offs)} equal to the "
          f"truncated truth")
    if err.max() > 1.0:
        bad = np.nonzero(err.max(axis=1) > 1.0)[0]
        raise AssertionError(f"pairs {bad.tolist()} off by more than 1 px: "
                             f"{offs[bad].tolist()} vs {truth[bad].tolist()}")
    h, w = frames.shape[1:]
    want = compute_placement(
        [tuple(o) for o in scan.expected_offsets[:len(offs)]], (h, w))
    got = compute_placement([tuple(o) for o in offs], (h, w))
    pano = res[0].image
    slack = np.abs(offs - scan.expected_offsets[:len(offs)]).sum(axis=0)
    if pano.shape != got.canvas_shape or np.any(
            np.abs(np.subtract(pano.shape, want.canvas_shape)) > slack):
        raise AssertionError(f"panorama {pano.shape}, true extent "
                             f"{want.canvas_shape}")
    for k, (r, c) in enumerate(got.positions):
        inner = pano[r + margin:r + h - margin, c + margin:c + w - margin]
        if not np.array_equal(inner, frames[k, margin:h - margin,
                                            margin:w - margin]):
            raise AssertionError(f"frame {k} interior not pasted verbatim")
    print(f"panorama {pano.shape} = the true extent; all {len(frames)} "
          "frame interiors verbatim")


def phase_flagship(scan, frames: np.ndarray, cfg, card: str, margin: int):
    """Phase 1: the flagship, cold then warm."""
    import jax
    t0 = time.perf_counter()
    res = stitch(frames, cfg)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = stitch(frames, cfg)
    warm = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    print(f"phase 1 flagship: {len(frames)} frames of {frames.shape[1:]}: "
          f"cold {cold:.3f} s, warm {warm:.3f} s "
          f"({len(frames) / warm:.2f} frames/s), peak device memory "
          f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB [{card}]")
    check_flagship(res, scan, frames, margin)
    return res


def phase_pool_profile(frames: np.ndarray, cfg, card: str, repeats: int = 3,
                       top: int = 12):
    """The detect/describe pool alone: warm ms/frame, then the top device
    operations of one traced call."""
    import dataclasses

    import jax
    from imagestitch_tpu.core import feature_registration as freg
    from imagestitch_tpu.utils import profiling
    cfg_pool = cfg.replace(features=dataclasses.replace(cfg.features,
                                                        upright=True))
    dev = jax.device_put(frames)
    jax.block_until_ready(freg._precompute_pool(dev, cfg_pool))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(freg._precompute_pool(dev, cfg_pool))
        times.append(time.perf_counter() - t0)
    per = statistics.median(times) / len(frames) * 1e3
    print(f"pool: {per:.3f} ms/frame warm (median of {repeats} calls over "
          f"{len(frames)} frames; {[round(t, 4) for t in times]} s) [{card}]")
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            jax.block_until_ready(freg._precompute_pool(dev, cfg_pool))
        ops, lines = profiling.device_op_times(d)
    total = sum(t for t, _ in ops.values())
    print(f"pool trace: {total:.3f} ms of device operations in one call; "
          f"lines {lines}")
    for name, (t, n) in sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {t:10.3f} ms {100 * t / max(total, 1e-9):5.1f}% x{n:<5d} "
              f"{name[:110]}")
    return per


def phase_reference(frames: np.ndarray, cfg, ref_device):
    """Phase 2: the same frames on ``ref_device`` (the CPU) vs the default
    device: identical offsets, panorama within the fade bound."""
    dev = stitch(frames, cfg)
    ref = stitch(frames, cfg, device=ref_device)
    a = [r.offsets for r in dev]
    b = [r.offsets for r in ref]
    if a != b or [r.file_range for r in dev] != [r.file_range for r in ref]:
        raise AssertionError(f"offsets differ from {ref_device}: {a} vs {b}")
    print(f"phase 2: {len(frames)} frames, offsets identical to "
          f"{ref_device.platform}")
    for x, y in zip(dev, ref):
        compare_panoramas(x.image, y.image,
                          f"phase 2 panorama vs {ref_device.platform}")


def phase_phase_corr(pair, ref_device):
    """Phase 3: phase correlation on a pair with a known offset."""
    frames = pair.frames()
    want = [tuple(int(v) for v in pair.expected_offsets[0])]
    for device in (None, ref_device):
        res = stitch(frames, iron_config(), device=device)
        got = [tuple(o) for r in res for o in r.offsets]
        where = "default device" if device is None else device.platform
        if got != want:
            raise AssertionError(f"phase 3 on {where}: offset {got}, "
                                 f"truth {want}")
        print(f"phase 3 phase correlation on {where}: offset {got[0]} == "
              f"truth (true {tuple(pair.true_offsets[0])})")


def phase_cli(frames: np.ndarray, cfg, platform: str):
    """Phase 4: ``cli stitch`` from PNG files in this process, against the
    library on the same frames."""
    from imagestitch_tpu import cli
    from imagestitch_tpu.io import codec
    with tempfile.TemporaryDirectory() as d:
        proj = os.path.join(d, "proj")
        for k, f in enumerate(frames):
            codec.imwrite(os.path.join(proj, "1", f"img-{k:03d}.png"), f)
        out = os.path.join(d, "out")
        rc = cli.main(["stitch", proj, out, "--file-extension", "png",
                       "--output-extension", "png",
                       "--registration", cfg.registration,
                       "--direction", str(cfg.direction),
                       "--direct-incre", str(cfg.direct_incre),
                       "--roi-ratio", str(cfg.roi_ratio),
                       "--fuse-method", cfg.fuse_method, "--gray", "--quiet",
                       "--platform", platform])
        if rc != 0:
            raise AssertionError(f"cli exited {rc}")
        pano = codec.imread(os.path.join(out, "stitching_result_1.png"),
                            color=False)
    lib = stitch(frames, cfg)
    if len(lib) != 1:
        raise AssertionError(f"library: {len(lib)} segments")
    compare_panoramas(pano, lib[0].image,
                      f"phase 4 cli ({len(frames)} PNG frames) vs library")


def phase_mesh(scan, frames: np.ndarray, cfg, n_devices: int, card: str,
               margin: int):
    """The flagship over an ``n_devices`` frame mesh against one device."""
    import jax
    from imagestitch_tpu.parallel.mesh import make_mesh
    if len(jax.devices()) < n_devices:
        raise RuntimeError(f"--devices {n_devices}: JAX sees "
                           f"{len(jax.devices())} devices")
    mesh = make_mesh(n_devices, axis="frames")
    single = stitch(frames, cfg)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        sharded = stitch(frames, cfg, mesh=mesh)
        times.append(time.perf_counter() - t0)
    print(f"mesh of {n_devices}: cold {times[0]:.3f} s, warm {times[1]:.3f} "
          f"s [{card}]")
    check_flagship(sharded, scan, frames, margin)
    if [r.offsets for r in sharded] != [r.offsets for r in single]:
        raise AssertionError("mesh offsets differ from one device")
    print(f"mesh of {n_devices}: offsets identical to one device")
    for a, b in zip(sharded, single):
        diff = np.abs(a.image.astype(np.int16) - b.image.astype(np.int16))
        print(f"mesh of {n_devices} vs one device: max |diff| "
              f"{int(diff.max())} LSB, {float(np.mean(diff > 0)):.3e} of "
              "pixels differ")
        if a.image.shape != b.image.shape or diff.max() > MAX_LSB:
            raise AssertionError("mesh panorama beyond 1 LSB of one device")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--devices", type=int, default=1, choices=[1, 4],
                   help="4: only the flagship over a 4-device mesh")
    args = p.parse_args(argv)

    # phase 2 needs the CPU backend beside the GPU
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax
    import jaxlib

    devices = jax.devices()
    check_platform(devices)

    from imagestitch_tpu.eval import seeded_scan
    from imagestitch_tpu.io import native_loader
    from imagestitch_tpu.utils.cache import enable_compilation_cache
    from imagestitch_tpu.utils.profiling import card_info

    # ---- phase 0: device and host paths
    cache = enable_compilation_cache()
    card = card_info()
    d0 = devices[0]
    try:
        from jax._src import xla_bridge
        backend_keys = sorted(xla_bridge._backends)
    except (ImportError, AttributeError):
        backend_keys = "unknown"
    print(f"device: {d0.platform} {d0.device_kind} x{len(devices)}; "
          f"jax {jax.__version__}, jaxlib {jaxlib.__version__}; "
          f"backends {backend_keys}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache "
          f"{cache}")
    print(f"card: {card}")
    lib = native_loader.get_lib()
    have = {}
    for mod in ("cv2", "PIL"):
        try:
            __import__(mod)
            have[mod] = True
        except ImportError:
            have[mod] = False
    native = (f"built ({native_loader.so_path()})" if lib is not None
              else f"absent ({native_loader.unavailable_reason()})")
    print(f"host: native runtime {native}, cv2 {have['cv2']}, "
          f"PIL {have['PIL']}")

    scan = seeded_scan.serpentine_scan(args.seed)
    t0 = time.perf_counter()
    frames = scan.frames()
    print(f"seeded scan {args.seed}: {frames.shape} in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = flagship_config()
    margin = 300      # clear of the <= 276 px in-column overlaps
    if args.devices > 1:
        phase_mesh(scan, frames, cfg, args.devices, card, margin)
    else:
        phase_flagship(scan, frames, cfg, card, margin)
        phase_pool_profile(frames, cfg, card)
        cpu = jax.devices("cpu")[0]
        phase_reference(frames[:8], cfg, cpu)
        phase_phase_corr(seeded_scan.offset_pair(args.seed), cpu)
        phase_cli(frames[:12], cfg, d0.platform)
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
