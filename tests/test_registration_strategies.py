"""Every --registration strategy end-to-end.

Round 1 shipped a crashing ``phase`` path because no test constructed it;
this module runs all five strategies through the Stitcher dispatch on
synthetic known-offset crops, plus the iron demo pair on the whole-image
phase path (reference analog: Stitcher.py:184-203).
"""
import os

import numpy as np
import pytest

from conftest import REFERENCE_DEMO, has_demo_images
from imagestitch_tpu import FeatureConfig, StitchConfig, Stitcher
from imagestitch_tpu.io import dataset

STRATEGIES = ["feature_incre", "feature", "phase_incre", "phase", "hybrid"]


def _textured(rng, shape, blobs):
    img = np.zeros(shape, np.float32)
    ys = rng.integers(5, shape[0] - 5, blobs)
    xs = rng.integers(5, shape[1] - 5, blobs)
    for y, x, a in zip(ys, xs, rng.uniform(50, 200, blobs)):
        img[y - 2:y + 3, x - 2:x + 3] += a
    return np.clip(img + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_recovers_known_offsets(strategy):
    rng = np.random.default_rng(13)
    base = _textured(rng, (900, 420), blobs=2800)
    h, w = 256, 300
    # 30% overlap, inside the scale-1 search strip (roi 0.2 -> strip 51 px,
    # margin 205, strip-local offset -25)
    tl = [(0, 0), (180, 4), (360, 1)]
    images = np.stack([base[r:r + h, c:c + w] for r, c in tl])
    cfg = StitchConfig(
        registration=strategy, direction=1, direct_incre=0,
        roi_ratio=0.2, offset_evaluate=3,
        features=FeatureConfig(max_keypoints=512, hessian_threshold=10.0))
    st = Stitcher(cfg)
    recs = st.register(images)
    assert [r.ok for r in recs] == [True, True], strategy
    got = [r.offset for r in recs]
    want = [(180, 4), (180, -3)]
    for g, t in zip(got, want):
        assert abs(g[0] - t[0]) <= 1 and abs(g[1] - t[1]) <= 1, (
            strategy, got, want)


def test_hybrid_fallback_evaluates_only_failed_pairs():
    """The phase fallback must dispatch over the FAILED
    pair subset, not re-sweep the whole sequence (wrong shape at 1000 tiles).
    """
    from imagestitch_tpu.core import registration as reg
    rng = np.random.default_rng(13)
    base = _textured(rng, (900, 420), blobs=2800)
    h, w = 256, 300
    tl = [(0, 0), (180, 4), (360, 1), (540, 2)]
    images = np.stack([base[r:r + h, c:c + w] for r, c in tl])
    # pair 1 is pure noise on both sides -> feature voting fails there
    images = images.copy()
    images[2] = rng.integers(0, 255, (h, w), np.uint8)
    cfg = StitchConfig(
        registration="hybrid", direction=1, direct_incre=0,
        roi_ratio=0.2, offset_evaluate=3,
        features=FeatureConfig(max_keypoints=512, hessian_threshold=10.0))
    recs = reg.register_sequence_hybrid(images, cfg)
    assert len(recs) == 3
    assert recs[0].ok and recs[0].offset == (180, 4)
    # the phase stage must have seen ONLY the failed pairs {1, 2}
    feat = reg.register_sequence_features_incre(images, cfg)
    failed = {k for k, r in enumerate(feat) if not r.ok}
    assert failed, "fixture must force at least one feature failure"
    assert set(reg.LAST_PHASE_STATS["pairs_evaluated"]) <= failed
    # feature-ok pairs keep their feature results
    for k, (f, m) in enumerate(zip(feat, recs)):
        if f.ok:
            assert m.offset == f.offset


@pytest.mark.skipif(not has_demo_images(),
                    reason="reference demoImages not present")
def test_phase_whole_image_iron():
    """The repaired whole-image phase path measures iron's 1698-row shift
    (2x linear padding; the reference's circular version would alias)."""
    from imagestitch_tpu.core import registration as reg
    files = dataset.list_project_images(os.path.join(REFERENCE_DEMO, "iron"), 1)
    batch = dataset.load_batch(files, color_mode=False)
    cfg = StitchConfig(registration="phase", direction=1, direct_incre=0)
    recs = reg.register_sequence_phase_whole(batch.gray, cfg)
    assert len(recs) == 1
    r = recs[0]
    assert r.ok, r
    assert abs(r.offset[0] - 1698) <= 1 and abs(r.offset[1]) <= 1, r.offset
    assert r.confidence > 0.15
