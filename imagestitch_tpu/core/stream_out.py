"""Bandwidth-optimal panorama output: device compute, delta-only readback.

The reference writes its panorama with one full host-side canvas pass
(reference: Stitcher.py:440-486).  Our device composer keeps the canvas in
device memory; materializing it on the host costs one full-panorama D2H
transfer, and the host<->device link is far slower than device memory.

Observation: after composition, every canvas pixel's LAST writer is either
  (a) a plain image paste — which the host can replay exactly, for free,
      from the decoded frames it already owns, or
  (b) a fused overlap-rect write — confined to the union of the per-pair
      fusion rects (a small fraction of the panorama: consecutive-pair
      overlaps only, reference Stitcher.py:457-469).
So the host reconstruction "paste all frames in placement order, then copy
the FINAL canvas content of every fusion rect" is pixel-exact, and only the
rects ever cross the link (~35 MB vs ~94 MB for the dendritic gray
panorama).  Rect reads happen as ONE jitted static-slice gather into a flat
buffer -> one contiguous readback.

Color goes further: the reference registers on grayscale and only loads
color at composition (Stitcher.py:68-69, :381-384), so shipping the color
batch to the device (3x the gray bytes) JUST to blend a fraction of its
pixels is pure waste.  ``compose_color_host`` replays the paste sequence
on a host canvas and evaluates each fusion rect with the float64 numpy
kernels (ops/fusion/host_blend.py) — the REFERENCE's own arithmetic
(ImageFusion.py:241-243 promotes through float64), with ZERO color bytes
crossing the link in either direction.  The device f32 composer agrees to
±1 LSB on a small share of blended pixels (asserted bounded in
tests/test_stream_out.py).

The full-readback path (core/compose.py + utils/transfer.read_back) remains
the default where the panorama's consumer is the device itself or the link
is fast; the CLI exposes ``--stream-output``.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import StitchConfig
from . import compose as compose_mod


def fuse_rects_of_steps(steps) -> Tuple[Tuple[int, int, int, int], ...]:
    """Static (rr, rc, rh, rw) tuples of every fuse step, in step order."""
    return tuple((s[3][0], s[3][1], s[4][0], s[4][1])
                 for s in steps if s[0] == "fuse")


def _subtract_one(piece, occ):
    """Rectangle subtraction: ``piece`` minus ``occ`` as <=4 disjoint
    rects.  Rects are (r0, c0, r1, c1) half-open."""
    pr0, pc0, pr1, pc1 = piece
    or0, oc0, or1, oc1 = occ
    ir0, ic0 = max(pr0, or0), max(pc0, oc0)
    ir1, ic1 = min(pr1, or1), min(pc1, oc1)
    if ir0 >= ir1 or ic0 >= ic1:
        return [piece]
    out = []
    if pr0 < ir0:
        out.append((pr0, pc0, ir0, pc1))          # band above
    if ir1 < pr1:
        out.append((ir1, pc0, pr1, pc1))          # band below
    if pc0 < ic0:
        out.append((ir0, pc0, ir1, ic0))          # left of the hole
    if ic1 < pc1:
        out.append((ir0, ic1, ir1, pc1))          # right of the hole
    return out


#: per-step piece-count cap before falling back to streaming the full rect
_MAX_PIECES = 64


def visible_rect_pieces(steps, image_shape: Tuple[int, int]
                        ) -> Tuple[Tuple[int, int, int, int], ...]:
    """Last-writer-visible pieces of every fusion rect, in step order.

    A fuse step's output only needs streaming where NO LATER step (paste
    or fused-rect write) overwrites it — subsequent writes are either
    replayed by the host paste or streamed by their own step.  Each rect
    is clipped against every later step's paste extent and fusion rect
    (reverse sweep with an occluder list); the surviving disjoint pieces
    are what crosses the link.  On the dendritic grid this collapses the
    reference-quirk full-frame rects (the running-canvas-extent overlap
    bound, Stitcher.py:413/418) to the truly-visible fraction.
    """
    h, w = image_shape
    occluders: List[Tuple[int, int, int, int]] = []
    per_step: List[List[Tuple[int, int, int, int]]] = []
    for s in reversed(steps):
        i, (r, c) = s[1], s[2]
        if s[0] == "fuse":
            (rr0, rc0), (rh, rw) = s[3], s[4]
            rect = (rr0, rc0, rr0 + rh, rc0 + rw)
            pieces = [rect]
            for occ in occluders:
                if occ[0] >= rect[2] or occ[2] <= rect[0] or \
                        occ[1] >= rect[3] or occ[3] <= rect[1]:
                    continue
                nxt = []
                for p in pieces:
                    nxt.extend(_subtract_one(p, occ))
                pieces = nxt
                if len(pieces) > _MAX_PIECES:
                    pieces = [rect]
                    break
            per_step.append(pieces)
            occluders.append(rect)
        else:
            per_step.append([])
        occluders.append((r, c, r + h, c + w))
    out: List[Tuple[int, int, int, int]] = []
    for pieces in reversed(per_step):
        for r0, c0, r1, c1 in pieces:
            out.append((r0, c0, r1 - r0, c1 - c0))
    return tuple(out)


@functools.partial(jax.jit, static_argnames=("rects",))
def _extract_rects_flat(canvas: jnp.ndarray,
                        rects: Tuple[Tuple[int, int, int, int], ...]
                        ) -> jnp.ndarray:
    """Concatenate the canvas content of every rect into one flat vector.

    Static-coordinate slices (placement is host-known), so XLA lowers this
    to plain copies; the single output crosses the link as one contiguous
    stream instead of K small transfers.
    """
    tail = canvas.shape[2:]
    parts = []
    for rr, rc, rh, rw in rects:
        sl = jax.lax.slice(canvas, (rr, rc) + (0,) * len(tail),
                           (rr + rh, rc + rw) + tail)
        parts.append(sl.reshape(-1))
    if not parts:
        return jnp.zeros((0,), canvas.dtype)
    return jnp.concatenate(parts)


def _paste_host(canvas: np.ndarray, img: np.ndarray, r: int, c: int) -> None:
    """Host paste; row-wise memcpy via the native runtime when available."""
    from ..io import native_loader
    lib = native_loader.get_lib()
    h, w = img.shape[:2]
    ch = img.shape[2] if img.ndim == 3 else 1
    if lib is not None and canvas.flags.c_contiguous and \
            img.flags.c_contiguous and canvas.dtype == np.uint8 \
            and img.dtype == np.uint8:
        import ctypes
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.isr_paste(canvas.ctypes.data_as(u8p), canvas.shape[0],
                      canvas.shape[1], ch, img.ctypes.data_as(u8p),
                      h, w, int(r), int(c))
    else:
        canvas[r:r + h, c:c + w] = img


def paste_all_host(frames: np.ndarray, placement, steps) -> np.ndarray:
    """Replay the paste sequence on a zeroed host canvas."""
    rows, cols = placement.canvas_shape
    ch = frames.shape[3] if frames.ndim == 4 else 1
    shape = (rows, cols, ch) if frames.ndim == 4 else (rows, cols)
    canvas = np.zeros(shape, np.uint8)
    for s in steps:
        i, (r, c) = s[1], s[2]
        _paste_host(canvas, frames[i], r, c)
    return canvas


def patch_rects_host(canvas: np.ndarray, rects, rect_stream: np.ndarray
                     ) -> np.ndarray:
    """Write streamed rect contents (``rects`` order) into the canvas."""
    ch = canvas.shape[2] if canvas.ndim == 3 else 1
    off = 0
    for rr, rc, rh, rw in rects:
        size = rh * rw * ch
        canvas[rr:rr + rh, rc:rc + rw] = \
            rect_stream[off:off + size].reshape((rh, rw, ch) if ch > 1
                                                else (rh, rw))
        off += size
    return canvas


def assemble_host(frames: np.ndarray, placement, steps,
                  rect_stream: np.ndarray) -> np.ndarray:
    """Paste frames in placement order, then patch in the streamed rects
    (full-rect stream variant)."""
    return patch_rects_host(paste_all_host(frames, placement, steps),
                            fuse_rects_of_steps(steps), rect_stream)


def compose_streamed(frames_host: np.ndarray,
                     offsets: Sequence[Tuple[int, int]],
                     cfg: StitchConfig,
                     frames_dev: Optional[jnp.ndarray] = None,
                     return_device: bool = False):
    """Device-composed panorama, host-materialized via rect-only readback.

    ``frames_host``: (N, H, W[, 3]) uint8 decoded frames (the host owns
    these anyway — they are the decode output).  ``frames_dev``: the same
    batch already in HBM, if the caller has it (registration just used it).
    Returns the host uint8 panorama; with ``return_device`` also the
    HBM-resident canvas.
    """
    from concurrent.futures import ThreadPoolExecutor

    from ..utils.transfer import read_back
    h, w = frames_host.shape[1], frames_host.shape[2]
    placement, steps, _ = compose_mod.plan_compose(offsets, (h, w), cfg)
    src = frames_dev if frames_dev is not None else frames_host
    pano_dev = compose_mod.compose(src, offsets, cfg, return_device=True)
    rects = visible_rect_pieces(steps, (h, w))
    flat = _extract_rects_flat(pano_dev, rects)
    # the host paste replay touches only host memory — run it concurrently
    # with the rect-stream D2H readback
    with ThreadPoolExecutor(max_workers=1) as ex:
        paste_fut = ex.submit(paste_all_host, frames_host, placement, steps)
        stream = read_back(flat)
        canvas = paste_fut.result()
    out = patch_rects_host(canvas, rects, stream)
    if return_device:
        return out, pano_dev
    return out


# --------------------------------------------------------------------------
# Host color composition (no color bytes cross the link)
# --------------------------------------------------------------------------

def compose_color_host(frames_color: np.ndarray,
                       offsets: Sequence[Tuple[int, int]],
                       cfg: StitchConfig) -> np.ndarray:
    """Color panorama computed host-side in the REFERENCE's float64.

    Replays the exact paste/fuse step sequence of the device composer on a
    host int16 canvas; each fusion rect runs the float64 numpy kernels
    (ops/fusion/host_blend.py) — the reference's own arithmetic
    (ImageFusion.py:241-243 promotes through float64, where the device
    kernels run f32 with a documented ±1-LSB divergence on ~5e-5 of
    blended pixels).  Zero color bytes cross the host<->device link in
    either direction.
    """
    assert frames_color.ndim == 4, "color batch expected"
    return compose_host(frames_color, offsets, cfg)


def compose_host(frames: np.ndarray,
                 offsets: Sequence[Tuple[int, int]],
                 cfg: StitchConfig) -> np.ndarray:
    """Host-native composition (gray or color) in the reference's float64.

    The generalization of ``compose_color_host`` to (N, H, W) gray
    batches: registration stays on the device (the compute-heavy stage);
    composition — a memory-speed operation the reference itself runs
    host-side — replays on a host int16 canvas through the threaded C
    kernels.  Output is reference-exact f64 arithmetic; the device f32
    composer agrees to ±1 LSB on a tiny blended fraction.
    """
    h, w = frames.shape[1], frames.shape[2]
    placement, steps, pairwise = compose_mod.plan_compose(
        offsets, (h, w), cfg)
    return _run_steps_host(frames, placement.canvas_shape, steps, pairwise,
                           cfg)


def compose_host_positions(frames: np.ndarray, positions: np.ndarray,
                           cfg: StitchConfig) -> np.ndarray:
    """Host f64 composition from ABSOLUTE tile positions (the global
    solver's output) — the host analog of compose_from_positions."""
    h, w = frames.shape[1], frames.shape[2]
    shape, steps, deltas = compose_mod.plan_compose_positions(
        positions, (h, w), cfg)
    return _run_steps_host(frames, shape, steps, deltas, cfg)


def _run_steps_host(frames: np.ndarray, canvas_shape, steps, pairwise,
                    cfg: StitchConfig) -> np.ndarray:
    from ..io import native_loader
    from ..ops.fusion import host_blend
    color = frames.ndim == 4
    assert cfg.fuse_method in compose_mod._PADDABLE_METHODS, \
        f"{cfg.fuse_method} is not supported by the host composer"
    h, w = frames.shape[1], frames.shape[2]
    ch = 3 if color else 1
    import ctypes
    rows, cols = canvas_shape
    shape = (rows, cols, 3) if color else (rows, cols)
    lib = native_loader.get_lib()
    native = (lib is not None
              and cfg.fuse_method in ("fadeInAndFadeOut", "trigonometric"))
    i16p = ctypes.POINTER(ctypes.c_int16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if native:
        canvas = np.empty(shape, np.int16)
        lib.isr_fill16(canvas.ctypes.data_as(i16p), canvas.size, -1, 0)
    else:
        canvas = np.full(shape, -1, np.int16)
    for s in steps:
        kind, i, (r, c) = s[0], s[1], s[2]
        frame = np.ascontiguousarray(frames[i])
        if kind == "paste":
            if native:
                lib.isr_paste16(canvas.ctypes.data_as(i16p), rows, cols, ch,
                                frame.ctypes.data_as(u8p), h, w,
                                int(r), int(c), 0)
            else:
                canvas[r:r + h, c:c + w] = frame
            continue
        (rr0, rc0), (rh, rw) = s[3], s[4]
        pw = pairwise[i]
        if native:
            _native_fuse_step(lib, canvas, frame, (r, c), (rr0, rc0, rh, rw),
                              pw, cfg.fuse_method)
            continue
        roi_a = canvas[rr0:rr0 + rh, rc0:rc0 + rw].astype(np.int32)
        canvas[r:r + h, c:c + w] = frame
        roi_b = canvas[rr0:rr0 + rh, rc0:rc0 + rw].astype(np.int32)
        fused = host_blend.fuse_region_np(roi_a, roi_b, pw[0], pw[1],
                                          cfg.fuse_method, color)
        canvas[rr0:rr0 + rh, rc0:rc0 + rw] = fused.astype(np.int16)
    if native:
        out = np.empty(shape, np.uint8)
        lib.isr_finalize16(canvas.ctypes.data_as(i16p),
                           out.ctypes.data_as(u8p), canvas.size, 0)
        return out
    return np.where(canvas == -1, 0, canvas).astype(np.uint8)


def _native_fuse_step(lib, canvas: np.ndarray, frame: np.ndarray,
                      pos, rect, pw, method: str) -> None:
    """One paste+fuse step fully in the C runtime (isr_fuse_step): stats in
    one pass, weight DECISIONS in Python (quirk-exact, host_blend), blend +
    paste + write-back in place on the int16 canvas — no rect copies."""
    import ctypes
    from ..ops.fusion import host_blend
    r, c = pos
    rr0, rc0, rh, rw = rect
    h, w = frame.shape[:2]
    ch = canvas.shape[2] if canvas.ndim == 3 else 1
    i16p = ctypes.POINTER(ctypes.c_int16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)
    quad = np.zeros(4, np.longlong)
    first_v = np.zeros(rw, np.int32)
    last_v = np.zeros(rw, np.int32)
    npos = np.zeros(1, np.longlong)
    lib.isr_rect_stats(
        canvas.ctypes.data_as(i16p), canvas.shape[1], ch,
        rr0, rc0, rh, rw,
        quad.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        first_v.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        last_v.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        npos.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
    valid_frac = float(npos[0]) / (rh * rw * ch)
    plain = valid_frac > 0.65
    zr = np.zeros(rh, np.float64)
    zc = np.zeros(rw, np.float64)
    if plain:
        if method == "fadeInAndFadeOut":
            war, wac, wbr, wbc = host_blend._plain_fade_vectors(
                (rh, rw), pw[0], pw[1])
            mode = 0
        else:
            if rw <= rh:
                j = np.arange(rw, dtype=np.float64)
                base = j / rw if pw[1] >= 0 else (rw - j) / rw
                war, wac = np.ones(rh, np.float64), base
            else:
                iv = np.arange(rh, dtype=np.float64)
                base = iv / rh if pw[0] <= 0 else (rh - iv) / rh
                war, wac = base, np.ones(rw, np.float64)
            wbr, wbc = zr, zc
            mode = 2
    else:
        def row_valid(ri):
            v = canvas[rr0 + ri, rc0:rc0 + rw]
            return (v.sum(axis=-1) != -3) if ch == 3 else (v != -1)
        wbr, wbc = host_blend.corner_vectors_from_stats(
            quad, first_v, last_v, row_valid, rh, rw)
        war, wac = zr, zc
        mode = 1 if method == "fadeInAndFadeOut" else 3
    war = np.ascontiguousarray(war, np.float64)
    wac = np.ascontiguousarray(wac, np.float64)
    wbr = np.ascontiguousarray(wbr, np.float64)
    wbc = np.ascontiguousarray(wbc, np.float64)
    lib.isr_fuse_step(
        canvas.ctypes.data_as(i16p), canvas.shape[0], canvas.shape[1], ch,
        frame.ctypes.data_as(u8p), h, w, int(r), int(c),
        int(rr0), int(rc0), int(rh), int(rw),
        war.ctypes.data_as(f64p), wac.ctypes.data_as(f64p),
        wbr.ctypes.data_as(f64p), wbc.ctypes.data_as(f64p),
        int(mode), 0)
