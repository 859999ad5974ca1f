"""Batched local descriptors at fixed capacity.

Batched analogs of the reference's descriptor families
(reference: ImageUtility.py:255-264 SIFT/SURF/ORB via OpenCV;
appendix/myGpuFeatures.cpp:77-118 CUDA):

  * "surf"  — 64-d Haar-gradient subregion sums (SURF)
  * "surf-extended" / "sift" — 128-d sign-split / orientation-binned variants
  * "orb"   — BRIEF-style intensity comparisons over the ``patch_size``
    window (ImageUtility.py:37), ``wta_k``-way (ImageUtility.py:36); bits
    are float {0,1} so Hamming matching is one matmul.

All are computed as one patch-slice gather per keypoint + register-resident
math — no per-keypoint host loops, fully batched over (P, K).

Orientation (``upright`` knob, ImageUtility.py:28): with upright=False the
descriptor window is rotated to the keypoint's dominant orientation —
Gaussian-weighted gradient direction for SURF/SIFT (a smooth simplification
of SURF's sliding-window Haar maximum), intensity centroid for ORB (exactly
cv2 ORB's rule) — sampled bilinearly from the gathered patch.  Micrograph
stages translate without rotating, so both settings register identically on
the demo sets; oriented mode matches the reference's default behavior.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_S = 16          # sample grid edge (SxS window)
_SUB = 4         # 4x4 subregions
_ORB_BITS = 256  # number of BRIEF tests


@dataclasses.dataclass(frozen=True)
class DescribeParams:
    """Static (hashable) descriptor configuration."""
    family: str = "surf"    # "surf" | "surf-extended" | "sift" | "orb"
    upright: bool = False   # ImageUtility.py:28 (False = oriented)
    patch_size: int = 31    # ORB BRIEF patch edge (ImageUtility.py:37)
    wta_k: int = 2          # points per BRIEF test (ImageUtility.py:36)


def descriptor_dim(params: DescribeParams) -> int:
    if params.family == "orb":
        return _ORB_BITS * (params.wta_k if params.wta_k > 2 else 1)
    return 64 if params.family == "surf" else 128


def _gauss_weight(s: int, sigma: float) -> np.ndarray:
    ax = np.arange(s, dtype=np.float64) - (s - 1) / 2.0
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    w = np.outer(g, g)
    return (w / w.sum()).astype(np.float32)


# --------------------------------------------------------------------------
# Patch gathering and bilinear resampling
# --------------------------------------------------------------------------

def _patch_gather(image: jnp.ndarray, rows: jnp.ndarray, cols: jnp.ndarray,
                  size: int, margin: int) -> jnp.ndarray:
    """(K, size, size) windows centered on each (rounded) keypoint.

    One ``lax.gather`` in SLICE mode: each keypoint fetches ``size``
    contiguous row segments instead of size*size scalar elements, so the
    gather moves rows rather than single elements.  CLIP mode clamps the
    slice start so out-of-range (padded/garbage) keypoints read an
    in-bounds window; detection's border suppression keeps real keypoints
    interior.
    """
    r0 = jnp.round(rows).astype(jnp.int32) - margin
    c0 = jnp.round(cols).astype(jnp.int32) - margin
    starts = jnp.stack([r0, c0], axis=-1)
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2), collapsed_slice_dims=(), start_index_map=(0, 1))
    return jax.lax.gather(image, starts, dn, slice_sizes=(size, size),
                          mode=jax.lax.GatherScatterMode.CLIP)


def _bilinear_from_patch(patch: jnp.ndarray, pr: jnp.ndarray, pc: jnp.ndarray
                         ) -> jnp.ndarray:
    """Bilinear samples at float patch coords.

    patch: (K, G, G); pr/pc: (K, ...) patch-frame coordinates.
    In-register resample: 4 ``take_along_axis`` gathers on the flattened
    patch, no image-sized memory touched.
    """
    k, g, _ = patch.shape
    shape = pr.shape
    r0 = jnp.clip(jnp.floor(pr).astype(jnp.int32), 0, g - 2)
    c0 = jnp.clip(jnp.floor(pc).astype(jnp.int32), 0, g - 2)
    fr = jnp.clip(pr - r0, 0.0, 1.0)
    fc = jnp.clip(pc - c0, 0.0, 1.0)
    flat = patch.reshape(k, g * g)

    def take(r, c):
        idx = (r * g + c).reshape(k, -1)
        return jnp.take_along_axis(flat, idx, axis=1).reshape(shape)

    return (take(r0, c0) * (1 - fr) * (1 - fc)
            + take(r0, c0 + 1) * (1 - fr) * fc
            + take(r0 + 1, c0) * fr * (1 - fc)
            + take(r0 + 1, c0 + 1) * fr * fc)


def _rot(theta: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """Rotate (row=u, col=v) offsets by per-keypoint theta: (K,...) pairs."""
    ct = jnp.cos(theta)
    st = jnp.sin(theta)
    while ct.ndim < u.ndim:
        ct = ct[..., None]
        st = st[..., None]
    return ct * u - st * v, st * u + ct * v


# --------------------------------------------------------------------------
# Gradient-grid construction (upright and oriented)
# --------------------------------------------------------------------------

def _grads_from_samples(q: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(K, S+2, S+2) samples -> smoothed (K, S, S) gradients (3-tap box +
    central difference, the pipeline _patch_grads always used)."""
    sm = 0.25 * q[:, :-2, :] + 0.5 * q[:, 1:-1, :] + 0.25 * q[:, 2:, :]
    gx = 0.5 * sm[:, :, :-2] - 0.5 * sm[:, :, 2:]
    dr = 0.5 * q[:, :-2, :] - 0.5 * q[:, 2:, :]
    gy = 0.25 * dr[:, :, :-2] + 0.5 * dr[:, :, 1:-1] + 0.25 * dr[:, :, 2:]
    return gx, gy


def _patch_grads(image: jnp.ndarray, rows: jnp.ndarray, cols: jnp.ndarray
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Upright descriptor-window gradients from ONE patch gather."""
    p = _patch_gather(image.astype(jnp.float32), rows, cols,
                      _S + 2, _S // 2)
    return _grads_from_samples(p)


_ORI_G = 29          # oriented gather patch edge
_ORI_R = _ORI_G // 2


# cv2-SURF orientation constants (modules/xfeatures2d surf.cpp semantics):
# samples on a radius-6 circle of the sigma grid, Gaussian sigma 2.5,
# sliding pi/3 window advanced in 5-degree steps.
_ORI_SPACING = 2           # px per sigma unit on the fixed 29px patch
_ORI_RADIUS = 6            # sample circle radius (sigma units)
_ORI_HAAR = 4 * _ORI_SPACING   # Haar wavelet edge (4 sigma)
_ORI_WIN = np.pi / 3.0
_ORI_STEPS = 72            # 360 / 5 degrees


def _ori_sample_layout():
    """Static sample coordinates + Gaussian weights of the cv2 scheme."""
    pts = []
    wts = []
    for i in range(-_ORI_RADIUS, _ORI_RADIUS + 1):
        for j in range(-_ORI_RADIUS, _ORI_RADIUS + 1):
            if i * i + j * j < _ORI_RADIUS * _ORI_RADIUS:
                pts.append((i, j))
                wts.append(float(np.exp(-(i * i + j * j) /
                                        (2.0 * 2.5 * 2.5))))
    return np.asarray(pts, np.int32), np.asarray(wts, np.float32)


_ORI_PTS, _ORI_WTS = _ori_sample_layout()


def _dominant_orientation(patch: jnp.ndarray) -> jnp.ndarray:
    """cv2-SURF dominant orientation per patch (K, G, G) -> (K,) radians.

    Exact algorithm shape (reference analog: ImageUtility.py:255-264's
    cv2 SURF): Haar x/y responses at the
    radius-6 sigma-grid circle samples, Gaussian-weighted (sigma 2.5),
    then a sliding pi/3 window over 5-degree starts; the window whose
    summed response vector has the largest norm gives the angle.
    """
    # integral image of the patch for O(1) Haar box sums
    ii = jnp.cumsum(jnp.cumsum(patch, axis=1), axis=2)
    ii = jnp.pad(ii, ((0, 0), (1, 0), (1, 0)))

    def box(r0, c0, r1, c1):
        # sum over patch[r0:r1, c0:c1] for every keypoint (static coords)
        return (ii[:, r1, c1] - ii[:, r0, c1] - ii[:, r1, c0]
                + ii[:, r0, c0])

    ctr = _ORI_R
    half = _ORI_HAAR // 2
    xs, ys = [], []
    for (si, sj), wt in zip(_ORI_PTS, _ORI_WTS):
        r = ctr + si * _ORI_SPACING
        c = ctr + sj * _ORI_SPACING
        r0, r1 = r - half, r + half
        c0, c1 = c - half, c + half
        # Haar dx: right half minus left half; dy: bottom minus top
        dx = box(r0, c, r1, c1) - box(r0, c0, r1, c)
        dy = box(r, c0, r1, c1) - box(r0, c0, r, c1)
        xs.append(dx * wt)
        ys.append(dy * wt)
    X = jnp.stack(xs, axis=-1)                   # (K, S)
    Y = jnp.stack(ys, axis=-1)
    ang = jnp.arctan2(Y, X)                      # (K, S) in (-pi, pi]
    ang = jnp.where(ang < 0, ang + 2 * jnp.pi, ang)
    starts = jnp.asarray(
        np.arange(_ORI_STEPS, dtype=np.float32) * (2 * np.pi / _ORI_STEPS))
    # membership: (angle - start) mod 2pi < pi/3
    d = ang[:, None, :] - starts[None, :, None]
    d = jnp.where(d < 0, d + 2 * jnp.pi, d)
    m = (d < _ORI_WIN).astype(jnp.float32)       # (K, W, S)
    # HIGHEST precision: TF32 would round the Haar sums to 10 mantissa
    # bits and can flip the argmax between neighbouring orientation windows
    sx = jnp.einsum("kws,ks->kw", m, X, precision=jax.lax.Precision.HIGHEST)
    sy = jnp.einsum("kws,ks->kw", m, Y, precision=jax.lax.Precision.HIGHEST)
    best = jnp.argmax(sx * sx + sy * sy, axis=-1)
    bx = jnp.take_along_axis(sx, best[:, None], axis=-1)[:, 0]
    by = jnp.take_along_axis(sy, best[:, None], axis=-1)[:, 0]
    return jnp.arctan2(by, bx)


def _oriented_patch_grads(image: jnp.ndarray, rows: jnp.ndarray,
                          cols: jnp.ndarray
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Keypoint-frame gradients: estimate the dominant orientation
    (cv2-SURF sliding-window Haar maximum, _dominant_orientation), then
    bilinearly sample the (S+2)^2 grid rotated by it.

    Finite differences along the rotated grid axes ARE the keypoint-frame
    gradients, so the downstream SURF/SIFT binning needs no change.
    """
    patch = _patch_gather(image.astype(jnp.float32), rows, cols,
                          _ORI_G, _ORI_R)
    theta = _dominant_orientation(patch)
    # rotated (S+2)^2 sampling grid, centered.  -theta: the grid's v axis
    # must map onto the dominant direction (row=sin, col=cos) so an image
    # rotation cancels; _rot(+theta) maps it to (-sin, cos) — measured
    # median descriptor cosine 0.58 under rot90 with the wrong sign vs
    # 0.97 with this one (r5 fix; the estimator itself is equivariant).
    base = jnp.arange(_S + 2, dtype=jnp.float32) - (_S + 1) / 2.0
    u = jnp.broadcast_to(base[:, None], (_S + 2, _S + 2))
    v = jnp.broadcast_to(base[None, :], (_S + 2, _S + 2))
    ru, rv = _rot(-theta, u[None], v[None])
    q = _bilinear_from_patch(patch, ru + _ORI_R, rv + _ORI_R)
    return _grads_from_samples(q)


# --------------------------------------------------------------------------
# SURF / SIFT descriptor binning
# --------------------------------------------------------------------------

def _surf_from_grads(gx: jnp.ndarray, gy: jnp.ndarray, extended: bool
                     ) -> jnp.ndarray:
    """(K, S, S) gradients -> (K, 64|128) SURF vector."""
    k = gx.shape[0]
    sub = _S // _SUB
    gxs = gx.reshape(k, _SUB, sub, _SUB, sub)
    gys = gy.reshape(k, _SUB, sub, _SUB, sub)
    if not extended:
        feats = jnp.stack([
            gxs.sum((2, 4)), gys.sum((2, 4)),
            jnp.abs(gxs).sum((2, 4)), jnp.abs(gys).sum((2, 4)),
        ], axis=-1)                                   # (K, 4, 4, 4)
    else:
        pos_y = (gys >= 0)
        pos_x = (gxs >= 0)
        feats = jnp.stack([
            jnp.where(pos_y, gxs, 0).sum((2, 4)),
            jnp.where(~pos_y, gxs, 0).sum((2, 4)),
            jnp.where(pos_y, jnp.abs(gxs), 0).sum((2, 4)),
            jnp.where(~pos_y, jnp.abs(gxs), 0).sum((2, 4)),
            jnp.where(pos_x, gys, 0).sum((2, 4)),
            jnp.where(~pos_x, gys, 0).sum((2, 4)),
            jnp.where(pos_x, jnp.abs(gys), 0).sum((2, 4)),
            jnp.where(~pos_x, jnp.abs(gys), 0).sum((2, 4)),
        ], axis=-1)                                   # (K, 4, 4, 8)
    d = feats.reshape(k, -1)
    return d / (jnp.linalg.norm(d, axis=-1, keepdims=True) + 1e-8)


def _sift_from_grads(gx: jnp.ndarray, gy: jnp.ndarray) -> jnp.ndarray:
    """(K, S, S) gradients -> (K, 128) SIFT vector (4x4x8 bins)."""
    k = gx.shape[0]
    mag = jnp.sqrt(gx * gx + gy * gy)
    ori = jnp.arctan2(gy, gx)                         # [-pi, pi)
    b = jnp.floor((ori + jnp.pi) / (2 * jnp.pi / 8)).astype(jnp.int32) % 8
    onehot = jax.nn.one_hot(b, 8, dtype=mag.dtype) * mag[..., None]
    sub = _S // _SUB
    hist = onehot.reshape(k, _SUB, sub, _SUB, sub, 8).sum((2, 4))
    d = hist.reshape(k, 128)
    d = d / (jnp.linalg.norm(d, axis=-1, keepdims=True) + 1e-8)
    d = jnp.minimum(d, 0.2)                           # SIFT clip
    return d / (jnp.linalg.norm(d, axis=-1, keepdims=True) + 1e-8)


# --------------------------------------------------------------------------
# ORB / BRIEF
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _orb_pattern(patch_size: int, wta_k: int, seed: int = 7) -> np.ndarray:
    """Fixed BRIEF sampling pattern: (_ORB_BITS, wta_k, 2) float offsets in
    the patch (Gaussian, sigma = patch/5, BRIEF's classic distribution),
    clipped one pixel inside so rotated bilinear samples stay in range."""
    rng = np.random.default_rng(seed)
    half = patch_size // 2
    pts = np.clip(rng.normal(0, patch_size / 5.0, (_ORB_BITS, max(wta_k, 2), 2)),
                  -(half - 1), half - 1)
    return pts.astype(np.float32)


def _orb_theta(patch: jnp.ndarray, half: int) -> jnp.ndarray:
    """ORB's intensity-centroid orientation: theta = atan2(m01, m10) over
    the patch disk (cv2 ORB's exact rule)."""
    g = patch.shape[-1]
    ax = jnp.arange(g, dtype=jnp.float32) - (g - 1) / 2.0
    rr = jnp.broadcast_to(ax[:, None], (g, g))
    cc = jnp.broadcast_to(ax[None, :], (g, g))
    disk = (rr * rr + cc * cc) <= float(half * half)
    pw = jnp.where(disk, patch, 0.0)
    m01 = jnp.sum(pw * rr, axis=(1, 2))
    m10 = jnp.sum(pw * cc, axis=(1, 2))
    return jnp.arctan2(m01, m10)


def _orb_bits(image: jnp.ndarray, rows: jnp.ndarray, cols: jnp.ndarray,
              smooth: jnp.ndarray, params: DescribeParams) -> jnp.ndarray:
    """(K, D) float {0,1} BRIEF bits (float form feeds the Hamming matmul).

    One patch-slice gather per keypoint (from the box-smoothed image, cv2's
    pre-smoothing), then all ``wta_k x 256`` test-point samples as bilinear
    reads from the register-resident patch.  Oriented (rBRIEF) unless
    ``upright``: the test pattern rotates by the intensity-centroid angle.
    """
    half = params.patch_size // 2
    # rotated points reach sqrt(2)*half; +2 bilinear/round margin
    g = 2 * (int(np.ceil(half * np.sqrt(2.0))) + 2) + 1
    margin = g // 2
    k = rows.shape[0]
    patch = _patch_gather(smooth, rows, cols, g, margin)
    pts = jnp.asarray(_orb_pattern(params.patch_size, params.wta_k))
    pu = jnp.broadcast_to(pts[None, :, :, 0], (k,) + pts.shape[:2])
    pv = jnp.broadcast_to(pts[None, :, :, 1], (k,) + pts.shape[:2])
    if params.upright:
        ru, rv = pu, pv
    else:
        theta = _orb_theta(patch, half)
        # -theta, as in _oriented_patch_grads: the pattern must rotate WITH
        # the content so an image rotation cancels (r5 sign fix; measured
        # median Hamming under rot90: 133/256 = random with +theta,
        # 0/256 with this)
        ru, rv = _rot(-theta, pu, pv)
    vals = _bilinear_from_patch(patch, ru + margin, rv + margin)  # (K, 256, k)
    if params.wta_k <= 2:
        return (vals[:, :, 0] < vals[:, :, 1]).astype(jnp.float32)
    # WTA_K > 2: each test emits argmax-of-k as a one-hot symbol; the
    # Hamming matmul identity then counts symbol AGREEMENTS, i.e. distance
    # = 2 * (#mismatched symbols) — cv2's NORM_HAMMING2 scale x2 (the
    # matcher threshold is scaled accordingly, see feature_registration).
    sym = jnp.argmax(vals[:, :, :params.wta_k], axis=-1)
    onehot = jax.nn.one_hot(sym, params.wta_k, dtype=jnp.float32)
    return onehot.reshape(k, _ORB_BITS * params.wta_k)


# --------------------------------------------------------------------------
# Pyramid-atlas describe (select-then-describe)
# --------------------------------------------------------------------------

#: guard rows between atlas bands — covers the largest descriptor window
#: margin (oriented gather patch: 29 px -> margin 14).
ATLAS_GUARD = 16


def describe_from_pyramid(octave_images, r_loc: jnp.ndarray,
                          c_loc: jnp.ndarray, octave_ids: jnp.ndarray,
                          params: DescribeParams) -> jnp.ndarray:
    """Describe keypoints spread across octave images with ONE batched call.

    Stacks the octave images into a vertical atlas (each band zero-padded to
    the full width and wrapped in ``ATLAS_GUARD`` zero rows), remaps each
    keypoint's octave-local row into the atlas, and runs ``describe_batch``
    once over all K selected keypoints.  This makes select-then-describe
    possible: the caller picks the global top-K across octaves FIRST and
    pays descriptor gather/math only for survivors (~45% less describe work
    than describe-then-select at the default octave budgets).

    Window contents are identical to per-octave describe for every keypoint
    whose window lies inside its octave image; a keypoint within a window
    margin of the octave edge reads guard zeros where the per-octave CLIP
    gather used to read an edge-shifted window (~2% of keypoints at the
    default borders; both are boundary heuristics).
    """
    w0 = octave_images[0].shape[1]
    bands = []
    offsets = []
    off = 0
    for im in octave_images:
        h_o, w_o = im.shape
        bands.append(jnp.pad(im.astype(jnp.float32),
                             ((ATLAS_GUARD, ATLAS_GUARD), (0, w0 - w_o))))
        offsets.append(off + ATLAS_GUARD)
        off += h_o + 2 * ATLAS_GUARD
    atlas = jnp.concatenate(bands, axis=0)
    band_off = jnp.take(jnp.asarray(offsets, jnp.float32),
                        octave_ids.astype(jnp.int32))
    r_atlas = r_loc + band_off
    return describe_batch(atlas[None], r_atlas[None], c_loc[None], params)[0]


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("params",))
def describe_batch(images: jnp.ndarray, rows: jnp.ndarray, cols: jnp.ndarray,
                   params: DescribeParams = DescribeParams()) -> jnp.ndarray:
    """Descriptors for a (P, H, W) image batch with (P, K) keypoints.

    Returns (P, K, D) float32 descriptors (D = 64/128, or 256*k {0,1} bits
    for "orb").  Invalid (padded) keypoints produce harmless garbage rows —
    the matcher masks them by score validity.
    """
    x = images.astype(jnp.float32)
    box = np.array([0.25, 0.5, 0.25], np.float32)
    gw = jnp.asarray(_gauss_weight(_S, _S / 2.0) * _S * _S)

    if params.family == "orb":
        from .detect import _sep_conv2
        smooth = _sep_conv2(x, box, box)
        return jax.vmap(lambda xi, r, c, s: _orb_bits(xi, r, c, s, params))(
            x, rows, cols, smooth)

    def one(x_i, r_i, c_i):
        if params.upright:
            gx, gy = _patch_grads(x_i, r_i, c_i)
        else:
            gx, gy = _oriented_patch_grads(x_i, r_i, c_i)
        sx = gx * gw
        sy = gy * gw
        if params.family == "sift":
            return _sift_from_grads(sx, sy)
        return _surf_from_grads(sx, sy,
                                extended=(params.family == "surf-extended"))

    return jax.vmap(one)(x, rows, cols)
