"""Tensor-parallel 2-D FFT phase correlation (SURVEY §2.3 TP row).

A single oversized overlap strip (reference analog: the whole-image
cv2.phaseCorrelate call, Stitcher.py:230) can exceed one device's memory once
padded to DFT size.  Here the 2-D FFT is sharded over the mesh: each device
FFTs its row block along the columns, an ``all_to_all`` re-shards from rows
to frequency columns, and the column FFT runs locally — the classic
transpose-decomposed parallel FFT, with XLA collectives between devices.  The
cross-power, inverse transform and peak search stay sharded end to end; no
device ever materializes the full padded array.

Layout walk-through (D devices, padded shape (HP, WP), both multiples of D):
  x        : (HP, WP)   sharded rows     -> local (HP/D, WP)
  fft axis1: local                      -> (HP/D, WP)
  all_to_all(split=1, concat=0)         -> (HP, WP/D)   sharded freq cols
  fft axis0: local                      -> full column FFT
  ... cross-power, ifft axis0 ...
  all_to_all(split=0, concat=1)         -> (HP/D, WP)   sharded rows
  ifft axis1 -> correlation surface, rows-sharded; peak via all_gather of
  per-device maxima + a psum-assembled 5-row window for the sub-pixel
  centroid (cv2 weightedCentroid semantics; the window WRAPS at the padded
  border instead of clipping — visible only for shifts within 2 px of the
  maximum representable, which 2x padding makes physically impossible).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import phase_corr


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.lru_cache(maxsize=32)
def _phase_tp_fn(mesh: Mesh, axis: str, hp: int, wp: int):
    d = mesh.devices.size
    hl = hp // d

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(axis), P(axis)), out_specs=(P(), P(), P()),
                       check_vma=False)
    def body(a_local, b_local):
        def fwd(x):
            f1 = jnp.fft.fft(x.astype(jnp.complex64), axis=1)
            cols = jax.lax.all_to_all(f1, axis, split_axis=1, concat_axis=0,
                                      tiled=True)          # (hp, wp/d)
            return jnp.fft.fft(cols, axis=0)

        fa = fwd(a_local)
        fb = fwd(b_local)
        p = fa * jnp.conj(fb)
        cps = p / (jnp.abs(p) + jnp.finfo(jnp.float32).tiny)
        ic = jnp.fft.ifft(cps, axis=0)                      # (hp, wp/d)
        rows = jax.lax.all_to_all(ic, axis, split_axis=0, concat_axis=1,
                                  tiled=True)               # (hp/d, wp)
        c = jnp.real(jnp.fft.ifft(rows, axis=1))            # rows-sharded

        # ---- global peak over the sharded surface ----
        me = jax.lax.axis_index(axis)
        flat = c.reshape(-1)
        loc_m = jnp.max(flat)
        loc_i = jnp.argmax(flat)
        gm = jax.lax.all_gather(loc_m, axis)                # (d,)
        gi = jax.lax.all_gather(loc_i + me * (hl * wp), axis)
        win_dev = jnp.argmax(gm)
        gidx = gi[win_dev]
        pr = (gidx // wp).astype(jnp.int32)                 # unrolled coords
        pc = (gidx % wp).astype(jnp.int32)

        # ---- 5-row window assembled by psum (each device owns hl rows) ----
        offs = jnp.arange(-2, 3)
        rows_needed = (pr + offs) % hp                      # (5,)
        own = (rows_needed >= me * hl) & (rows_needed < (me + 1) * hl)
        lidx = jnp.clip(rows_needed - me * hl, 0, hl - 1)
        contrib = jnp.where(own[:, None], c[lidx], 0.0)
        win_rows = jax.lax.psum(contrib, axis)              # (5, wp) replicated
        cols = (pc + offs) % wp
        win = win_rows[:, cols]                             # (5, 5)

        # centroid in ROLLED (fftshift) coordinates: rolled peak q = (p +
        # size/2) mod size; window coords = q + offs (wrap-free near q)
        qr = ((pr + hp // 2) % hp).astype(jnp.float32)
        qc = ((pc + wp // 2) % wp).astype(jnp.float32)
        s = jnp.sum(win)
        tiny = jnp.finfo(jnp.float32).tiny
        cr = qr + jnp.sum(win * offs[:, None].astype(jnp.float32)) / (s + tiny)
        cc = qc + jnp.sum(win * offs[None, :].astype(jnp.float32)) / (s + tiny)
        resp = s  # ifft normalization already includes 1/(hp*wp)
        return hp / 2.0 - cr, wp / 2.0 - cc, resp

    return jax.jit(body)


def phase_correlate_sharded(a: np.ndarray, b: np.ndarray, mesh: Mesh,
                            hp: Optional[int] = None,
                            wp: Optional[int] = None
                            ) -> Tuple[float, float, float]:
    """Phase-correlate ONE oversized pair with the FFT sharded over ``mesh``.

    Returns (shift_x, shift_y, response) with cv2's (x=col, y=row)
    convention — drop-in for ``phase_corr._phase_correlate_one``.
    """
    h, w = a.shape
    d = mesh.devices.size
    axis = mesh.axis_names[0]
    hp = _pad_to(hp or phase_corr.optimal_dft_size(h), d)
    wp = _pad_to(wp or phase_corr.optimal_dft_size(w), d)
    shard = NamedSharding(mesh, P(axis))

    def pad(x):
        buf = np.zeros((hp, wp), np.float32)
        buf[:h, :w] = x
        return jax.device_put(buf, shard)

    sy_x = _phase_tp_fn(mesh, axis, hp, wp)(pad(a), pad(b))
    sy, sx, resp = (float(np.asarray(v)) for v in sy_x)
    # body returns (row_shift, col_shift, resp); map to cv2 (x, y)
    return sx, sy, resp


def phase_correlate_auto(a: np.ndarray, b: np.ndarray,
                         mesh: Optional[Mesh],
                         per_chip_budget_bytes: int = 2 << 30
                         ) -> Tuple[float, float, float]:
    """Single-chip phase correlation, or the sharded path when the padded
    working set would exceed ``per_chip_budget_bytes`` on one chip.

    Working-set model: ~6 padded complex64 surfaces live at the peak of the
    single-chip pipeline (two spectra, cross-power, inverse, temporaries).
    """
    h, w = a.shape
    hp = phase_corr.optimal_dft_size(h)
    wp = phase_corr.optimal_dft_size(w)
    working = 6 * hp * wp * 8
    if mesh is None or mesh.devices.size == 1 or working <= per_chip_budget_bytes:
        sx, sy, resp = phase_corr._phase_correlate_one(
            jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32), hp, wp)
        return float(sx), float(sy), float(resp)
    return phase_correlate_sharded(a, b, mesh, hp, wp)
