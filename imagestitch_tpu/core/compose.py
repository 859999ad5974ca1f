"""Canvas placement and composition.

The reference composes with a dynamically-grown int64 canvas using a ``-1``
sentinel, rebasing every previously-placed image whenever a cumulative offset
goes non-positive (reference: Stitcher.py:369-486).  That design transiently
allocates ~0.7 GB for the 90-image dendritic grid and runs serial Python.

Batched redesign:
  * placement is pure integer bookkeeping on the host (exact reference
    semantics, including the running-max occupancy quirk of rangeX/rangeY);
  * the canvas is allocated ONCE at its final size as an int16 device buffer
    (sentinel -1 preserved, 4x smaller than the reference's int64), and
  * pastes + overlap fusion run on device; identical rect shapes share one
    compiled program.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import StitchConfig
from ..ops.fusion import blend
from ..ops.fusion import pyramid as fusion_pyramid
from ..ops.fusion import seam as fusion_seam


@dataclasses.dataclass
class Placement:
    """Result of the placement pass."""
    positions: List[Tuple[int, int]]      # top-left (row, col) per image
    canvas_shape: Tuple[int, int]         # (rows, cols)
    range_rows: List[Tuple[int, int]]     # occupancy [min,max) rows per image
    range_cols: List[Tuple[int, int]]     # occupancy [min,max) cols per image


def compute_placement(offsets: Sequence[Tuple[int, int]],
                      image_shape: Tuple[int, int]) -> Placement:
    """Pairwise offsets -> absolute placements + canvas size.

    Exact semantics of the reference's first composition pass
    (Stitcher.py:387-431): prefix sums with negative rebase, a canvas that
    only ever grows, and the occupancy ranges whose upper bound is the
    *running* canvas extent at placement time (a reference quirk the fusion
    rect computation depends on — rangeX[i][1]=resultRow at Stitcher.py:413/418).
    """
    h, w = image_shape
    n = len(offsets) + 1
    pos = [[0, 0] for _ in range(n)]
    range_r = [[0, 0] for _ in range(n)]
    range_c = [[0, 0] for _ in range(n)]
    range_r[0][1] = h
    range_c[0][1] = w
    rows, cols = h, w
    drow_sum = dcol_sum = 0
    for i in range(1, n):
        drow_sum += offsets[i - 1][0]
        dcol_sum += offsets[i - 1][1]
        if drow_sum <= 0:
            shift = -drow_sum
            for j in range(i):
                pos[j][0] += shift
                range_r[j][0] += shift
                range_r[j][1] += shift
            rows += shift
            range_r[i][1] = rows
            drow_sum = 0
            pos[i][0] = 0
        else:
            pos[i][0] = drow_sum
            rows = max(rows, drow_sum + h)
            range_r[i][1] = rows
        if dcol_sum <= 0:
            shift = -dcol_sum
            for j in range(i):
                pos[j][1] += shift
                range_c[j][0] += shift
                range_c[j][1] += shift
            cols += shift
            range_c[i][1] = cols
            dcol_sum = 0
            pos[i][1] = 0
        else:
            pos[i][1] = dcol_sum
            cols = max(cols, dcol_sum + w)
            range_c[i][1] = cols
        range_r[i][0] = pos[i][0]
        range_c[i][0] = pos[i][1]
    return Placement(positions=[tuple(p) for p in pos],
                     canvas_shape=(rows, cols),
                     range_rows=[tuple(r) for r in range_r],
                     range_cols=[tuple(c) for c in range_c])


# --------------------------------------------------------------------------
# Device-side canvas ops.  Canvas is int16 (-1 sentinel, values 0..255).
# --------------------------------------------------------------------------

@functools.partial(jax.jit, donate_argnames=("canvas",))
def _paste(canvas: jnp.ndarray, image: jnp.ndarray, r: jnp.ndarray, c: jnp.ndarray):
    """Overwrite-paste ``image`` at (r, c); donated buffer -> in-place."""
    return jax.lax.dynamic_update_slice(
        canvas, image.astype(canvas.dtype), (r, c) + (0,) * (canvas.ndim - 2))


@functools.partial(jax.jit, static_argnames=("rh", "rw"), donate_argnames=("canvas",))
def _paste_and_fuse(canvas: jnp.ndarray, image: jnp.ndarray,
                    r: jnp.ndarray, c: jnp.ndarray,
                    rr: jnp.ndarray, rc: jnp.ndarray, rh: int, rw: int,
                    fused: jnp.ndarray):
    """Paste image then write the fused rect (reference pass-2 order,
    Stitcher.py:474-483)."""
    zeros = (0,) * (canvas.ndim - 2)
    canvas = jax.lax.dynamic_update_slice(canvas, image.astype(canvas.dtype),
                                          (r, c) + zeros)
    canvas = jax.lax.dynamic_update_slice(canvas, fused.astype(canvas.dtype),
                                          (rr, rc) + zeros)
    return canvas


@functools.partial(jax.jit, static_argnames=("rh", "rw"))
def _read_rect(canvas: jnp.ndarray, rr: jnp.ndarray, rc: jnp.ndarray,
               rh: int, rw: int) -> jnp.ndarray:
    sizes = (rh, rw) + canvas.shape[2:]
    return jax.lax.dynamic_slice(canvas, (rr, rc) + (0,) * (canvas.ndim - 2),
                                 sizes).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("rh", "rw"), donate_argnames=("canvas",))
def _paste_rect_region(canvas: jnp.ndarray, image: jnp.ndarray,
                       r: jnp.ndarray, c: jnp.ndarray,
                       rr: jnp.ndarray, rc: jnp.ndarray, rh: int, rw: int):
    """Paste, then return (canvas, roiB) where roiB is the rect after paste."""
    zeros = (0,) * (canvas.ndim - 2)
    canvas = jax.lax.dynamic_update_slice(canvas, image.astype(canvas.dtype),
                                          (r, c) + zeros)
    roi_b = jax.lax.dynamic_slice(canvas, (rr, rc) + zeros,
                                  (rh, rw) + canvas.shape[2:]).astype(jnp.int32)
    return canvas, roi_b


@functools.partial(jax.jit, donate_argnames=("canvas",))
def _finalize(canvas: jnp.ndarray) -> jnp.ndarray:
    """-1 sentinel -> 0, cast uint8 (Stitcher.py:485-486)."""
    return jnp.where(canvas == -1, 0, canvas).astype(jnp.uint8)


def _fuse_dispatch(roi_a, roi_b, drow, dcol, method: str, color: bool):
    if method == "multiBandBlending":
        return fusion_pyramid.fuse_multiband(roi_a, roi_b)
    if method == "optimalSeamLine":
        return fusion_seam.fuse_optimal_seam(roi_a, roi_b)
    return blend.fuse_region(roi_a, roi_b, drow, dcol, method, color)


@functools.partial(jax.jit, static_argnames=("rh", "rw", "method", "color"),
                   donate_argnames=("canvas",))
def _fused_steps_scan(canvas: jnp.ndarray, imgs: jnp.ndarray,
                      pos: jnp.ndarray, rects: jnp.ndarray,
                      pairwise: jnp.ndarray, rh: int, rw: int,
                      method: str, color: bool) -> jnp.ndarray:
    """Run a GROUP of same-rect-shape paste+fuse steps in ONE dispatch.

    The serial reference issues one host call per image
    (Stitcher.py:440-483); issuing one device call per image pays a dispatch
    round trip each.  Consecutive steps whose fusion rects share a shape
    (whole grid rows at a time) run as a single lax.scan.
    """
    zeros = (0,) * (canvas.ndim - 2)

    def step(cv, x):
        img, p, rect, pw = x
        r, c = p[0], p[1]
        rr, rc = rect[0], rect[1]
        roi_a = jax.lax.dynamic_slice(cv, (rr, rc) + zeros,
                                      (rh, rw) + cv.shape[2:]).astype(jnp.int32)
        cv = jax.lax.dynamic_update_slice(cv, img.astype(cv.dtype),
                                          (r, c) + zeros)
        roi_b = jax.lax.dynamic_slice(cv, (rr, rc) + zeros,
                                      (rh, rw) + cv.shape[2:]).astype(jnp.int32)
        fused = _fuse_dispatch(roi_a, roi_b, pw[0], pw[1], method, color)
        cv = jax.lax.dynamic_update_slice(cv, fused.astype(cv.dtype),
                                          (rr, rc) + zeros)
        return cv, None

    canvas, _ = jax.lax.scan(step, canvas, (imgs, pos, rects, pairwise))
    return canvas


def _bucket(x: int, lo: int = 64) -> int:
    """Round a rect dim up to a power of two (>= lo)."""
    b = lo
    while b < x:
        b *= 2
    return b


@functools.partial(jax.jit, static_argnames=("bh", "bw", "method", "color"),
                   donate_argnames=("canvas",))
def _fused_steps_scan_padded(canvas: jnp.ndarray, imgs: jnp.ndarray,
                             pos: jnp.ndarray, anchors: jnp.ndarray,
                             geoms: jnp.ndarray, pairwise: jnp.ndarray,
                             bh: int, bw: int,
                             method: str, color: bool) -> jnp.ndarray:
    """Same-BUCKET paste+fuse steps in one dispatch.

    Every fusion rect is padded to the (bh, bw) shape bucket; the padded
    read/compute/write covers the true rect (geoms = per-step
    (orow, ocol, rh, rw) inside the window) and is a verbatim no-op outside
    it (blend.fuse_region_padded).  One compiled program per bucket instead
    of one per distinct overlap shape — the dendritic grid alone has ~80
    distinct shapes.
    """
    zeros = (0,) * (canvas.ndim - 2)

    def step(cv, x):
        img, p, anc, g, pw = x
        roi_a = jax.lax.dynamic_slice(cv, (anc[0], anc[1]) + zeros,
                                      (bh, bw) + cv.shape[2:]).astype(jnp.int32)
        cv = jax.lax.dynamic_update_slice(cv, img.astype(cv.dtype),
                                          (p[0], p[1]) + zeros)
        roi_b = jax.lax.dynamic_slice(cv, (anc[0], anc[1]) + zeros,
                                      (bh, bw) + cv.shape[2:]).astype(jnp.int32)
        fused = blend.fuse_region_padded(roi_a, roi_b, pw[0], pw[1],
                                         g[0], g[1], g[2], g[3],
                                         method, color)
        cv = jax.lax.dynamic_update_slice(cv, fused.astype(cv.dtype),
                                          (anc[0], anc[1]) + zeros)
        return cv, None

    canvas, _ = jax.lax.scan(step, canvas,
                             (imgs, pos, anchors, geoms, pairwise))
    return canvas


@functools.partial(jax.jit, donate_argnames=("canvas",))
def _paste_steps_scan(canvas: jnp.ndarray, imgs: jnp.ndarray,
                      pos: jnp.ndarray) -> jnp.ndarray:
    """A group of plain overwrite pastes in one dispatch."""
    zeros = (0,) * (canvas.ndim - 2)

    def step(cv, x):
        img, p = x
        return jax.lax.dynamic_update_slice(
            cv, img.astype(cv.dtype), (p[0], p[1]) + zeros), None

    canvas, _ = jax.lax.scan(step, canvas, (imgs, pos))
    return canvas


def compose(images: np.ndarray, offsets: Sequence[Tuple[int, int]],
            cfg: StitchConfig,
            subpix_offsets: Optional[Sequence[Tuple[float, float]]] = None,
            return_device: bool = False) -> np.ndarray:
    """Compose a registered sequence into one panorama.

    ``images``: (N, H, W) or (N, H, W, 3) uint8 batch (capture order).
    ``offsets``: N-1 pairwise (drow, dcol) ints.
    Returns the uint8 panorama on the host.

    Semantics parity with Stitcher.py:440-486: image i is fused only against
    the occupancy rect of image i-1; the fuse rect sees the canvas before and
    after pasting image i; fusion uses the *pairwise* offset of pair (i-1, i).
    Execution: steps grouped by fusion-rect shape, each group one lax.scan
    dispatch over a donated HBM canvas.
    """
    n = images.shape[0]
    assert len(offsets) == n - 1, (len(offsets), n)
    color = images.ndim == 4
    if cfg.fuse_method in ("multiBandBlending", "optimalSeamLine"):
        assert not color, f"{cfg.fuse_method} supports gray only (ref parity)"
    h, w = images.shape[1], images.shape[2]
    placement, steps, pairwise = plan_compose(offsets, (h, w), cfg)
    rows, cols = placement.canvas_shape
    shape = (rows, cols, 3) if color else (rows, cols)
    canvas = jnp.full(shape, -1, jnp.int16)
    images_dev = jnp.asarray(images)

    return _run_steps(steps, images_dev, canvas, pairwise, cfg, color,
                      return_device)


def plan_compose(offsets: Sequence[Tuple[int, int]],
                 image_shape: Tuple[int, int], cfg: StitchConfig):
    """Placement + per-image step classification, shared by the device
    composer and the streamed-output assembler (core/stream_out.py).

    Returns ``(placement, steps, pairwise)`` where each step is
    ``("paste", i, (r, c), None, None)`` or
    ``("fuse", i, (r, c), (rr0, rc0), (rh, rw))`` (reference pass-2
    classification, Stitcher.py:440-483: image i fuses only against the
    occupancy rect of image i-1).
    """
    h, w = image_shape
    n = len(offsets) + 1
    placement = compute_placement(offsets, (h, w))
    pairwise = [(0, 0)] + [tuple(o) for o in offsets]
    steps = []
    for i in range(n):
        r, c = placement.positions[i]
        if i == 0 or cfg.fuse_method == "notFuse":
            steps.append(("paste", i, (r, c), None, None))
            continue
        rr0 = max(r, placement.range_rows[i - 1][0])
        rc0 = max(c, placement.range_cols[i - 1][0])
        rr1 = min(r + h, placement.range_rows[i - 1][1])
        rc1 = min(c + w, placement.range_cols[i - 1][1])
        if rr1 - rr0 <= 0 or rc1 - rc0 <= 0:
            steps.append(("paste", i, (r, c), None, None))
        else:
            steps.append(("fuse", i, (r, c), (rr0, rc0),
                          (rr1 - rr0, rc1 - rc0)))
    return placement, steps, pairwise


def compose_from_positions(images: np.ndarray,
                           positions: np.ndarray,
                           cfg: StitchConfig,
                           return_device: bool = False) -> np.ndarray:
    """Compose from ABSOLUTE tile positions (global-solver output).

    New capability: the reference can only chain pairwise offsets
    (Stitcher.py:404-405); here globally-optimized poses (solver/pose_graph)
    place every tile.  Fusion runs against the previous tile's true extent;
    the fusion ramp direction uses the consecutive position delta.
    """
    color = images.ndim == 4
    h, w = images.shape[1], images.shape[2]
    (rows, cols), steps, deltas = plan_compose_positions(
        positions, (h, w), cfg)
    shape = (rows, cols, 3) if color else (rows, cols)
    canvas = jnp.full(shape, -1, jnp.int16)
    images_dev = jnp.asarray(images)
    return _run_steps(steps, images_dev, canvas, deltas, cfg, color,
                      return_device)


def plan_compose_positions(positions: np.ndarray,
                           image_shape: Tuple[int, int], cfg: StitchConfig):
    """Canvas size + step classification for ABSOLUTE tile positions
    (global-solver output); shared by the device and host composers.
    Returns ``((rows, cols), steps, deltas)``.
    """
    h, w = image_shape
    pos = np.round(np.asarray(positions, np.float64)).astype(np.int64)
    pos -= pos.min(axis=0)
    n = pos.shape[0]
    rows = int(pos[:, 0].max()) + h
    cols = int(pos[:, 1].max()) + w
    deltas = [(0, 0)] + [tuple((pos[i] - pos[i - 1]).tolist())
                         for i in range(1, n)]
    steps = []
    for i in range(n):
        r, c = int(pos[i, 0]), int(pos[i, 1])
        if i == 0 or cfg.fuse_method == "notFuse":
            steps.append(("paste", i, (r, c), None, None))
            continue
        pr, pc = int(pos[i - 1, 0]), int(pos[i - 1, 1])
        rr0, rc0 = max(r, pr), max(c, pc)
        rr1, rc1 = min(r + h, pr + h), min(c + w, pc + w)
        if rr1 - rr0 <= 0 or rc1 - rc0 <= 0:
            steps.append(("paste", i, (r, c), None, None))
        else:
            steps.append(("fuse", i, (r, c), (rr0, rc0),
                          (rr1 - rr0, rc1 - rc0)))
    return (rows, cols), steps, deltas


_PADDABLE_METHODS = ("notFuse", "average", "maximum", "minimum",
                     "fadeInAndFadeOut", "trigonometric")


def plan_groups(steps, fuse_method: str, rows: int, cols: int):
    """Normalize + group the per-image step list for scan execution.

    Paddable blend modes rewrite every fuse step to ONE shared shape bucket
    ("fusep": anchor + per-step geometry inside the padded window); exact
    -shape modes (multiband / optimal-seam) group runs of identical rect
    shapes.  Returns a list of groups
    ``(kind, rect_shape, idxs, pos, aux, geoms)`` where aux is anchors
    (fusep) or rects (fuse) and geoms is the per-step (orow, ocol, rh, rw)
    for fusep, else None.  Shared by the single-chip and the sharded
    composer so both issue one device dispatch per group.
    """
    paddable = fuse_method in _PADDABLE_METHODS
    fuse_rects = [s[4] for s in steps if s[0] == "fuse"] if paddable else []
    if fuse_rects:
        gbh = min(max(_bucket(rh) for rh, _ in fuse_rects), rows)
        gbw = min(max(_bucket(rw) for _, rw in fuse_rects), cols)
    norm = []
    for s in steps:
        if s[0] == "paste" or not paddable:
            norm.append(s + ((None,) if len(s) == 5 else ()))
            continue
        kind, i, p, (rr0, rc0), (rh, rw) = s
        bh, bw = gbh, gbw
        ar = min(rr0, rows - bh)
        ac = min(rc0, cols - bw)
        norm.append(("fusep", i, p, (ar, ac), (bh, bw),
                     (rr0 - ar, rc0 - ac, rh, rw)))

    groups = []
    gi = 0
    while gi < len(norm):
        kind = norm[gi][0]
        rect_shape = norm[gi][4]
        gj = gi
        while gj + 1 < len(norm) and norm[gj + 1][0] == kind and \
                norm[gj + 1][4] == rect_shape:
            gj += 1
        group = norm[gi:gj + 1]
        idxs = [s[1] for s in group]
        pos = [s[2] for s in group]
        aux = [s[3] for s in group] if kind != "paste" else None
        geoms = [s[5] for s in group] if kind == "fusep" else None
        groups.append((kind, rect_shape, idxs, pos, aux, geoms))
        gi = gj + 1
    return groups


def _run_steps(steps, images_dev, canvas, pairwise, cfg: StitchConfig,
               color: bool, return_device: bool = False) -> np.ndarray:
    rows, cols = canvas.shape[0], canvas.shape[1]
    for kind, rect_shape, idxs, pos, aux, geoms in plan_groups(
            steps, cfg.fuse_method, rows, cols):
        imgs = images_dev[jnp.asarray(idxs, jnp.int32)]
        pos = jnp.asarray(pos, jnp.int32)
        if kind == "paste":
            canvas = _paste_steps_scan(canvas, imgs, pos)
        elif kind == "fusep":
            anchors = jnp.asarray(aux, jnp.int32)
            geoms = jnp.asarray(geoms, jnp.int32)
            pws = jnp.asarray([pairwise[i] for i in idxs], jnp.int32)
            bh, bw = rect_shape
            canvas = _fused_steps_scan_padded(canvas, imgs, pos, anchors,
                                              geoms, pws, bh, bw,
                                              cfg.fuse_method, color)
        else:  # exact-shape path (multiband / optimal-seam)
            rects = jnp.asarray(aux, jnp.int32)
            pws = jnp.asarray([pairwise[i] for i in idxs], jnp.int32)
            rh, rw = rect_shape
            canvas = _fused_steps_scan(canvas, imgs, pos, rects, pws,
                                       rh, rw, cfg.fuse_method, color)
    out = _finalize(canvas)
    if return_device:
        return out  # leave in HBM (host readback is the caller's choice)
    from ..utils.transfer import read_back
    return read_back(out)   # concurrent chunked D2H (utils/transfer.py)
