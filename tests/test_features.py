"""Feature pipeline: detector repeatability, matcher, mode vote vs oracle."""
import numpy as np
import jax.numpy as jnp
import pytest

from imagestitch_tpu import StitchConfig, FeatureConfig
from imagestitch_tpu.core import feature_registration as freg
from imagestitch_tpu.ops.features import detect, describe, match, vote
from oracle import mode_offset_oracle


def _textured(rng, shape, blobs=300):
    """Random blob field — repeatable structure for detection."""
    img = np.zeros(shape, np.float32)
    ys = rng.integers(5, shape[0] - 5, blobs)
    xs = rng.integers(5, shape[1] - 5, blobs)
    amps = rng.uniform(50, 200, blobs)
    for y, x, a in zip(ys, xs, amps):
        img[y - 2:y + 3, x - 2:x + 3] += a
    img = np.clip(img + rng.normal(0, 5, shape), 0, 255)
    return img.astype(np.uint8)


def test_mode_vote_matches_oracle(rng):
    """Vote kernel == reference getOffsetByMode on random match sets."""
    for trial in range(20):
        k = 64
        n_matches = int(rng.integers(0, k))
        kps_a = rng.uniform(0, 500, (k, 2)).astype(np.float32)  # (x, y)
        kps_b = rng.uniform(0, 500, (k, 2)).astype(np.float32)
        # make many matches share a common displacement
        common = rng.integers(-100, 100, 2)
        matches = []
        for i in range(n_matches):
            q = int(rng.integers(0, k))
            t = int(rng.integers(0, k))
            if rng.uniform() < 0.6:
                kps_b[t] = kps_a[q] - np.array(
                    [common[1], common[0]], np.float32) - rng.uniform(0, 0.4, 2)
            matches.append((t, q))
        ok_o, off_o = mode_offset_oracle(kps_a, kps_b, matches, 3)

        d_row = np.zeros(k, np.int32)
        d_col = np.zeros(k, np.int32)
        valid = np.zeros(k, bool)
        # jam the matches into fixed slots in order (slot order = match order)
        for slot, (t, q) in enumerate(matches[:k]):
            pa = (kps_a[q][1], kps_a[q][0])
            pb = (kps_b[t][1], kps_b[t][0])
            d_row[slot] = int(pa[0] - pb[0])
            d_col[slot] = int(pa[1] - pb[1])
            valid[slot] = True
        dr, dc, n, _ = vote.mode_vote_batch(jnp.asarray(d_row)[None],
                                            jnp.asarray(d_col)[None],
                                            jnp.asarray(valid)[None])
        got_ok = bool(n[0] >= 3)
        assert got_ok == ok_o, (trial, int(n[0]), off_o)
        if ok_o:
            assert (int(dr[0]), int(dc[0])) == tuple(off_o), trial


def test_detector_repeatable_under_translation(rng):
    base = _textured(rng, (400, 600))
    a = base[50:350, 60:500]
    b = base[80:380, 35:475]  # shifted (30, -25)
    rows, cols, scores = detect.detect_batch(
        jnp.asarray(np.stack([a, b])), 256,
        detect.DetectParams(threshold=10.0))
    rows, cols, scores = map(np.asarray, (rows, cols, scores))
    # content at base(R, C): in a at (R-50, C-60), in b at (R-80, C-35)
    ka = set(zip(np.round(rows[0] - 30).astype(int),
                 np.round(cols[0] + 25).astype(int)))
    kb = set(zip(np.round(rows[1]).astype(int),
                 np.round(cols[1]).astype(int)))
    # at least half of A's keypoints reappear at the translated position +-0
    inter = len(ka & kb)
    assert inter > 0.4 * min((scores[0] > 0).sum(), (scores[1] > 0).sum())


@pytest.mark.parametrize("method", ["surf", "sift", "orb"])
def test_feature_registration_recovers_translation(rng, method):
    """End-to-end synthetic check: known integer offsets recovered exactly."""
    base = _textured(rng, (800, 500), blobs=2500)
    h, w = 256, 384
    tl = [(0, 0), (180, 7), (360, 3)]
    images = np.stack([base[r:r + h, c:c + w] for r, c in tl])
    cfg = StitchConfig(
        registration="feature_incre", direction=1, direct_incre=0,
        roi_ratio=0.4, offset_evaluate=3,
        features=FeatureConfig(method=method, max_keypoints=512,
                               hessian_threshold=10.0))
    recs = freg.register_sequence_features_incre(images, cfg)
    assert [r.ok for r in recs] == [True, True]
    assert recs[0].offset == (180, 7)
    assert recs[1].offset == (180, -4)


def test_whole_image_feature_registration(rng):
    base = _textured(rng, (900, 400), blobs=2000)
    h, w = 256, 300
    tl = [(0, 0), (150, 5), (300, 2), (450, 0)]
    images = np.stack([base[r:r + h, c:c + w] for r, c in tl])
    cfg = StitchConfig(
        registration="feature", direction=1, direct_incre=0,
        offset_evaluate=3,
        features=FeatureConfig(method="surf", max_keypoints=512,
                               hessian_threshold=10.0))
    recs = freg.register_sequence_features(images, cfg)
    assert [r.ok for r in recs] == [True, True, True]
    assert recs[0].offset == (150, 5)
    assert recs[1].offset == (150, -3)
    assert recs[2].offset == (150, -2)


class TestSurfOrientation:
    """cv2-SURF sliding-window orientation (describe._dominant_orientation;
    reference analog ImageUtility.py:255-264)."""

    def test_linear_gradient_recovers_direction(self):
        import jax.numpy as jnp
        from imagestitch_tpu.ops.features import describe as D
        yy, xx = np.mgrid[0:29, 0:29]
        for deg in (0, 30, 77, 150, 245, 300):
            phi = np.deg2rad(deg)
            g = (np.cos(phi) * xx + np.sin(phi) * yy).astype(np.float32)
            th = float(D._dominant_orientation(jnp.asarray(g[None]))[0])
            err = (th - phi + np.pi) % (2 * np.pi) - np.pi
            assert abs(np.rad2deg(err)) < 3.0, (deg, np.rad2deg(th))

    def test_rot90_equivariance(self, rng):
        """Rotating the patch 90deg CCW shifts the dominant angle by -90deg
        (y-down image coords) within the 5-degree window resolution."""
        import jax.numpy as jnp
        from imagestitch_tpu.ops.features import describe as D
        base = rng.normal(size=(40, 40))
        # smooth it so a dominant direction exists (pure noise has none)
        k = np.ones((5, 5)) / 25.0
        from scipy.ndimage import convolve
        sm = convolve(base, k).astype(np.float32)[5:34, 5:34]
        t0 = float(D._dominant_orientation(jnp.asarray(sm[None]))[0])
        t1 = float(D._dominant_orientation(
            jnp.asarray(np.rot90(sm).copy()[None]))[0])
        d = np.rad2deg((t1 - t0) % (2 * np.pi))
        assert abs(d - 270.0) < 8.0, d

    def test_oriented_descriptors_rotation_invariant(self, rng):
        """Oriented SURF descriptors survive a 90-degree image rotation
        statistically (median cosine over many keypoints; individual
        near-tie patches can flip orientation windows, as cv2's do);
        upright descriptors do not.  Guards the r5 grid-rotation sign fix
        (median was 0.58 = broken before)."""
        import jax.numpy as jnp
        from imagestitch_tpu.ops.features import describe as D
        from scipy.ndimage import convolve
        img = convolve(rng.normal(size=(256, 256)),
                       np.ones((5, 5)) / 25.0).astype(np.float32)
        img = (127 + 60 * img).clip(0, 255).astype(np.uint8)
        rot = np.rot90(img).copy()
        n = 128
        rs = rng.uniform(40, 216, n).astype(np.float32)
        cs = rng.uniform(40, 216, n).astype(np.float32)
        # rot90 CCW: (r, c) -> (N-1-c, r)
        r1, c1 = 255 - cs, rs
        med = {}
        for upright in (False, True):
            p = D.DescribeParams(family="surf", upright=upright)
            d0 = np.asarray(D.describe_batch(
                jnp.asarray(img)[None], jnp.asarray(rs)[None],
                jnp.asarray(cs)[None], p))[0]
            d1 = np.asarray(D.describe_batch(
                jnp.asarray(rot)[None], jnp.asarray(r1)[None],
                jnp.asarray(c1)[None], p))[0]
            cos = (d0 * d1).sum(1) / (np.linalg.norm(d0, axis=1)
                                      * np.linalg.norm(d1, axis=1) + 1e-9)
            med[upright] = float(np.median(cos))
        assert med[False] > 0.9, med
        assert med[True] < 0.8, med

    def test_orb_oriented_rotation_invariant(self, rng):
        """ORB's rotated BRIEF pattern: rot90 leaves descriptors
        bit-identical at the median (intensity-centroid theta is exactly
        90-degree equivariant); upright ORB is near-random (~128/256)."""
        import jax.numpy as jnp
        from imagestitch_tpu.ops.features import describe as D
        from scipy.ndimage import convolve
        img = convolve(rng.normal(size=(256, 256)),
                       np.ones((5, 5)) / 25.0).astype(np.float32)
        img = (127 + 60 * img).clip(0, 255).astype(np.uint8)
        rot = np.rot90(img).copy()
        n = 128
        rs = rng.uniform(40, 216, n).astype(np.float32)
        cs = rng.uniform(40, 216, n).astype(np.float32)
        r1, c1 = 255 - cs, rs
        med = {}
        for upright in (False, True):
            p = D.DescribeParams(family="orb", upright=upright)
            d0 = np.asarray(D.describe_batch(
                jnp.asarray(img)[None], jnp.asarray(rs)[None],
                jnp.asarray(cs)[None], p))[0]
            d1 = np.asarray(D.describe_batch(
                jnp.asarray(rot)[None], jnp.asarray(r1)[None],
                jnp.asarray(c1)[None], p))[0]
            med[upright] = float(np.median(np.abs(d0 - d1).sum(1)))
        assert med[False] <= 16, med
        assert med[True] >= 96, med
