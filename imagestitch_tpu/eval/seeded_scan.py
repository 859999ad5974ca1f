"""Seeded serpentine tile scans with known geometry.

A stand-in for the reference's dendritic demo set (89 frames of
1936x2584, reference Stitcher.py:87) that needs no download: frames are cut
from ONE procedural field of multi-scale Gaussian blobs, so the feature
path registers every adjacent pair, and the generator knows the true
pairwise offsets.

Geometry follows the dendritic scan: columns of frames stepping down (then
up, serpentine) by 1660-1884 px with 0-3 px of jitter across, joined by
row transitions of about (-10, +2410) px.  Stage positions are not
pixel-aligned: frame k is sampled at a fractional origin whose fraction is
0.5 px in both axes on odd frames, so every true pairwise offset is an
integer plus 0.5.  The reference truncates keypoint displacements toward
zero (ImageUtility.py:160-161); at a .5 fraction the truncated vote is
unambiguous, so ``expected_offsets`` is exactly what a correct registrar
reports, on any backend.

The field is evaluated tile by tile — one frame's blobs at a time — and
the canvas is never allocated.
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

#: blob scale bands (sigma range in px, mean spacing in px).  Spacing grows
#: with scale so each band covers a similar share of the field, and the
#: bands span the detector's four octaves (base sigma 1.2, 2x per octave).
_BANDS = ((1.5, 3.0, 24.0), (3.0, 6.0, 48.0), (6.0, 12.0, 96.0),
          (12.0, 16.0, 160.0))
_BACKGROUND = 128.0
_AMPLITUDE = (50.0, 110.0)     # blob contrast, random sign
_NOISE = 2.0                   # per-frame sensor noise (grey levels, std)


@dataclasses.dataclass(frozen=True)
class SerpentineScan:
    """A seeded scan: frame origins on one blob field, rendered on demand."""
    seed: int
    frame_shape: Tuple[int, int]
    origins: np.ndarray            # (N, 2) float64 canvas (row, col)
    blobs: Tuple[np.ndarray, ...]  # per band: (M, 4) row, col, sigma, amp

    @property
    def n_frames(self) -> int:
        return int(self.origins.shape[0])

    @property
    def true_offsets(self) -> np.ndarray:
        """(N-1, 2) float offsets of frame k+1 relative to frame k."""
        return np.diff(self.origins, axis=0)

    @property
    def expected_offsets(self) -> np.ndarray:
        """(N-1, 2) int offsets a registrar reports: the true offsets
        truncated toward zero (the reference's int() convention)."""
        return np.trunc(self.true_offsets).astype(np.int64)

    def frame(self, k: int) -> np.ndarray:
        """Render frame ``k`` as (H, W) uint8."""
        h, w = self.frame_shape
        oy, ox = self.origins[k]
        acc = np.zeros(h * w, np.float64)
        for band in self.blobs:
            r = int(np.ceil(3.0 * band[:, 2].max())) if len(band) else 0
            ry = band[:, 0] - oy
            rx = band[:, 1] - ox
            sel = (ry > -r - 1) & (ry < h + r) & (rx > -r - 1) & (rx < w + r)
            if not sel.any():
                continue
            ry, rx = ry[sel], rx[sel]
            sig, amp = band[sel, 2], band[sel, 3]
            cy = np.rint(ry).astype(np.int64)
            cx = np.rint(rx).astype(np.int64)
            t = np.arange(-r, r + 1)
            inv = 1.0 / (2.0 * sig * sig)
            gy = np.exp(-((t[None] - (ry - cy)[:, None]) ** 2) * inv[:, None])
            gx = np.exp(-((t[None] - (rx - cx)[:, None]) ** 2) * inv[:, None])
            rows = cy[:, None] + t[None]
            cols = cx[:, None] + t[None]
            # out-of-frame taps land in one spill bin past the frame
            rows = np.where((rows >= 0) & (rows < h), rows * w, h * w)
            cols = np.where((cols >= 0) & (cols < w), cols, h * w)
            idx = np.minimum(rows[:, :, None] + cols[:, None, :], h * w)
            wgt = (amp[:, None] * gy)[:, :, None] * gx[:, None, :]
            acc += np.bincount(idx.ravel(), weights=wgt.ravel(),
                               minlength=h * w + 1)[:h * w]
        noise = np.random.default_rng([self.seed, k]).normal(0.0, _NOISE,
                                                             h * w)
        img = np.rint(_BACKGROUND + acc + noise)
        return np.clip(img, 0, 255).astype(np.uint8).reshape(h, w)

    def frames(self, idx: Optional[Sequence[int]] = None) -> np.ndarray:
        """Render several frames as one (n, H, W) uint8 batch."""
        idx = range(self.n_frames) if idx is None else idx
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            return np.stack(list(ex.map(self.frame, [int(k) for k in idx])))


def serpentine_origins(rng: np.random.Generator, n_frames: int,
                       column_length: int, step: Tuple[int, int],
                       jitter: int, transition_col: Tuple[int, int],
                       transition_row: Tuple[int, int]) -> np.ndarray:
    """(N, 2) frame origins of a serpentine scan, shifted to >= 0."""
    pos = [np.zeros(2)]
    for k in range(1, n_frames):
        if k % column_length == 0:          # step to the next column
            d = (rng.integers(transition_row[0], transition_row[1] + 1),
                 rng.integers(transition_col[0], transition_col[1] + 1))
        else:
            down = (k // column_length) % 2 == 0
            s = rng.integers(step[0], step[1] + 1)
            d = (s if down else -s, rng.integers(-jitter, jitter + 1))
        pos.append(pos[-1] + np.asarray(d, np.float64))
    org = np.stack(pos)
    org -= org.min(axis=0)
    org += 0.5 * (np.arange(n_frames) % 2)[:, None]
    return org


def serpentine_scan(seed: int = 0, n_frames: int = 89,
                    frame_shape: Tuple[int, int] = (1936, 2584),
                    column_length: int = 15,
                    step: Tuple[int, int] = (1660, 1884), jitter: int = 3,
                    transition_col: Tuple[int, int] = (2405, 2478),
                    transition_row: Tuple[int, int] = (-16, -2)
                    ) -> SerpentineScan:
    """The dendritic-shaped scan (defaults: 89 frames of 1936x2584 in
    columns of 15).  Smaller shapes take their own step ranges."""
    rng = np.random.default_rng(seed)
    org = serpentine_origins(rng, n_frames, column_length, step, jitter,
                             transition_col, transition_row)
    return _on_field(rng, seed, org, frame_shape)


def offset_pair(seed: int, frame_shape: Tuple[int, int] = (1936, 2584),
                offset: Tuple[int, int] = (1698, 2)) -> SerpentineScan:
    """Two frames, the second ``offset`` (+0.5 px in both axes) from the
    first — the iron demo's shape (README quick start).

    The incremental phase path truncates the offset WITHIN the search strip
    before adding the strip's margin (reference Stitcher.py:231-253); that
    equals ``expected_offsets`` when the in-strip offset is positive, i.e.
    when the overlap is smaller than the first ROI strip."""
    org = np.asarray([[0.0, 0.0], [offset[0] + 0.5, offset[1] + 0.5]])
    org -= org.min(axis=0)
    return _on_field(np.random.default_rng(seed), seed, org, frame_shape)


def _on_field(rng: np.random.Generator, seed: int, org: np.ndarray,
              frame_shape: Tuple[int, int]) -> SerpentineScan:
    """Scatter each band's blobs over the scan's bounding box."""
    h, w = frame_shape
    lo = org.min(axis=0) - 64.0
    hi = org.max(axis=0) + np.asarray([h, w], np.float64) + 64.0
    area = float(np.prod(hi - lo))
    blobs = []
    for s_lo, s_hi, spacing in _BANDS:
        m = int(area / (spacing * spacing))
        pos = lo + rng.random((m, 2)) * (hi - lo)
        sig = s_lo * (s_hi / s_lo) ** rng.random(m)
        amp = rng.uniform(*_AMPLITUDE, m) * rng.choice([-1.0, 1.0], m)
        blobs.append(np.column_stack([pos, sig, amp]))
    return SerpentineScan(seed=seed, frame_shape=(h, w), origins=org,
                          blobs=tuple(blobs))
