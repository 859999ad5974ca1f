"""Every surviving config knob changes behavior.

The round-1 review found ~15 knobs that were carried for parity but never
read.  Each test here toggles one knob and asserts an observable behavioral
difference, so a knob can never silently regress to parity theater again.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from imagestitch_tpu import FeatureConfig, StitchConfig
from imagestitch_tpu.core import feature_registration as freg
from imagestitch_tpu.ops.features import describe, detect, match
from imagestitch_tpu.utils.records import print_and_write


def _textured(rng, shape=(200, 260), blobs=250):
    img = np.zeros(shape, np.float32)
    ys = rng.integers(5, shape[0] - 5, blobs)
    xs = rng.integers(5, shape[1] - 5, blobs)
    for y, x, a in zip(ys, xs, rng.uniform(50, 200, blobs)):
        img[y - 2:y + 3, x - 2:x + 3] += a
    return np.clip(img + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def img():
    return _textured(np.random.default_rng(7))


def _detect(img, **kw):
    p = detect.DetectParams(**kw)
    r, c, s = detect.detect_batch(jnp.asarray(img)[None], 128, p)
    return np.asarray(r[0]), np.asarray(c[0]), np.asarray(s[0])


def _keyset(r, c, s):
    return set(zip(np.round(r[s > 0]).astype(int),
                   np.round(c[s > 0]).astype(int)))


# ---- hessian-family detector knobs ----------------------------------------

def test_n_octaves_changes_detection(img):
    a = _detect(img, n_octaves=1)
    b = _detect(img, n_octaves=4)
    assert not np.allclose(a[2], b[2])


def test_n_octave_layers_changes_detection(img):
    a = _detect(img, n_octave_layers=1)
    b = _detect(img, n_octave_layers=3)
    assert not np.allclose(a[2], b[2])


def test_box_filter_changes_detection(img):
    a = _detect(img, box_filter=False)
    b = _detect(img, box_filter=True, threshold=1.0)
    assert not np.allclose(a[2], b[2])


def test_subpixel_changes_positions(img):
    # octave 0 only so coordinates are octave-offset-free
    r_i, c_i, s_i = _detect(img, subpixel=False, n_octaves=1)
    r_f, c_f, s_f = _detect(img, subpixel=True, n_octaves=1)
    assert np.all(r_i == np.round(r_i))          # integer without subpixel
    frac = np.abs(r_f[s_f > 0] - np.round(r_f[s_f > 0]))
    assert np.any(frac > 1e-3)                   # fractional with subpixel
    # refinement never moves a keypoint more than half a pixel
    assert np.all(np.abs(r_f[s_f > 0] - r_i[s_i > 0]) <= 0.5 + 1e-6)


def test_hessian_threshold_gates_keypoints(img):
    lo = _detect(img, threshold=10.0)
    hi = _detect(img, threshold=1e7)
    assert (lo[2] > 0).sum() > (hi[2] > 0).sum()


def test_compute_dtype_changes_response(img):
    a = _detect(img, dtype="float32")
    b = _detect(img, dtype="bfloat16")
    assert not np.array_equal(a[2], b[2])


# ---- corner/ORB-family detector knobs --------------------------------------

def test_orb_n_levels_changes_detection(img):
    a = _detect(img, family="corner", n_levels=1)
    b = _detect(img, family="corner", n_levels=4)
    assert _keyset(*a) != _keyset(*b)


def test_orb_scale_factor_changes_detection(img):
    a = _detect(img, family="corner", scale_factor=1.2)
    b = _detect(img, family="corner", scale_factor=1.7)
    assert not np.allclose(a[2], b[2])


def test_orb_first_level_changes_detection(img):
    a = _detect(img, family="corner", first_level=0)
    b = _detect(img, family="corner", first_level=2)
    assert _keyset(*a) != _keyset(*b)


def test_orb_fast_threshold_gates_corners(img):
    lo = _detect(img, family="corner", fast_threshold=5.0)
    hi = _detect(img, family="corner", fast_threshold=120.0)
    assert (lo[2] > 0).sum() > (hi[2] > 0).sum()


def test_orb_edge_threshold_suppresses_border(img):
    r, c, s = _detect(img, family="corner", edge_threshold=60, n_levels=1)
    r, c = r[s > 0], c[s > 0]
    h, w = img.shape
    assert r.size and np.all((r >= 59) & (r < h - 59))
    assert np.all((c >= 59) & (c < w - 59))


def test_orb_n_features_caps_capacity():
    cfg = StitchConfig(features=FeatureConfig(method="orb",
                                              orb_n_features=77))
    assert freg._capacity(cfg, 1024) == 77
    cfg2 = StitchConfig(features=FeatureConfig(method="surf",
                                               orb_n_features=77))
    assert freg._capacity(cfg2, 1024) == 1024


# ---- descriptor knobs -------------------------------------------------------

def _describe(img, r, c, **kw):
    p = describe.DescribeParams(**kw)
    return np.asarray(describe.describe_batch(
        jnp.asarray(img)[None], jnp.asarray(r)[None], jnp.asarray(c)[None],
        p)[0])


def test_upright_changes_descriptors(img):
    r, c, s = _detect(img)
    a = _describe(img, r, c, family="surf", upright=True)
    b = _describe(img, r, c, family="surf", upright=False)
    assert not np.allclose(a, b)


def test_orb_patch_size_changes_bits(img):
    r, c, s = _detect(img, family="corner")
    a = _describe(img, r, c, family="orb", patch_size=31)
    b = _describe(img, r, c, family="orb", patch_size=15)
    assert not np.array_equal(a, b)


def test_orb_wta_k_changes_descriptor(img):
    r, c, s = _detect(img, family="corner")
    a = _describe(img, r, c, family="orb", wta_k=2)
    b = _describe(img, r, c, family="orb", wta_k=3)
    assert a.shape[-1] == 256 and b.shape[-1] == 768
    # wta_k=3 descriptors are one-hot symbols: exactly 256 ones per row
    assert np.all(b.sum(-1) == 256)


def test_orb_max_distance_gates_matches():
    rng = np.random.default_rng(11)
    da = jnp.asarray((rng.uniform(size=(64, 256)) > 0.5).astype(np.float32))
    db = jnp.asarray((rng.uniform(size=(64, 256)) > 0.5).astype(np.float32))
    v = jnp.ones(64, bool)
    _, ok_hi = match.match_nearest_hamming(da, db, v, v, max_distance=256.0)
    _, ok_lo = match.match_nearest_hamming(da, db, v, v, max_distance=1.0)
    assert ok_hi.sum() > ok_lo.sum()


def test_search_ratio_gates_matches():
    rng = np.random.default_rng(12)
    base = rng.normal(0, 1, (64, 64)).astype(np.float32)
    da = jnp.asarray(base + rng.normal(0, 0.3, base.shape).astype(np.float32))
    db = jnp.asarray(base)
    v = jnp.ones(64, bool)
    _, ok_loose = match.match_ratio(da, db, v, v, 0.99)
    _, ok_tight = match.match_ratio(da, db, v, v, 0.3)
    assert ok_loose.sum() > ok_tight.sum()


def test_effective_max_distance_scales_for_wta3():
    cfg2 = StitchConfig(features=FeatureConfig(method="orb", orb_wta_k=2))
    cfg3 = StitchConfig(features=FeatureConfig(method="orb", orb_wta_k=3))
    assert freg._effective_max_distance(cfg2) == 30.0
    assert freg._effective_max_distance(cfg3) == 60.0


# ---- logging sink (printAndWrite parity) ------------------------------------

def test_evaluate_sink_writes_file(tmp_path, capsys):
    cfg = StitchConfig(print_log=True, evaluate=True,
                       output_address=str(tmp_path),
                       evaluate_file="audit.txt")
    print_and_write(cfg, "offset is [3, 4]")
    print_and_write(cfg, "second line")
    out = capsys.readouterr().out
    assert "offset is [3, 4]" in out
    with open(os.path.join(str(tmp_path), "audit.txt")) as f:
        lines = f.read().splitlines()
    assert lines == ["offset is [3, 4]", "second line"]


def test_evaluate_sink_off_by_default(tmp_path):
    cfg = StitchConfig(print_log=False, evaluate=False,
                       output_address=str(tmp_path))
    print_and_write(cfg, "nope")
    assert not os.path.exists(os.path.join(str(tmp_path), "evaluate.txt"))
