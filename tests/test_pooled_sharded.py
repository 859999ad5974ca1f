"""Mesh-distributed flagship registration + driver.

The sharded pooled path must equal the single-device pooled path exactly
(same math, different partitioning), and the ONE driver (Stitcher with a
mesh) must produce the identical panorama.
"""
import numpy as np
import pytest

from imagestitch_tpu import FeatureConfig, StitchConfig, Stitcher
from imagestitch_tpu.core import feature_registration as freg
from imagestitch_tpu.parallel import pooled_sharded
from imagestitch_tpu.parallel.mesh import make_mesh


def _serpentine(rng, n=9, h=128, w=192):
    """Synthetic serpentine grid sequence: down, right, up (direction turns)."""
    base = np.clip(rng.normal(128, 40, (3 * h + 200, 2 * w + 200)), 0,
                   255).astype(np.uint8)
    # blobs for features
    ys = rng.integers(5, base.shape[0] - 5, 6000)
    xs = rng.integers(5, base.shape[1] - 5, 6000)
    for y, x in zip(ys, xs):
        base[y - 1:y + 2, x - 1:x + 2] = rng.integers(0, 255)
    tl = [(0, 0), (90, 2), (180, 1),            # down column
          (181, 140),                            # right step (direction turn)
          (91, 139), (1, 141),                   # up column
          (0, 260), (95, 261), (185, 262)]       # right + down again
    return np.stack([base[r:r + h, c:c + w] for r, c in tl]), tl


@pytest.fixture(scope="module")
def seq():
    rng = np.random.default_rng(7)
    return _serpentine(rng)


def _cfg(**kw):
    return StitchConfig(
        registration="feature_incre", direction=1, direct_incre=1,
        roi_ratio=0.2, offset_evaluate=3, color_mode=False,
        features=FeatureConfig(max_keypoints=256, pool_keypoints=512), **kw)


def test_sharded_incre_equals_unsharded(seq):
    images, _ = seq
    cfg = _cfg()
    mesh = make_mesh(8, axis="frames")
    ref = freg.register_sequence_features_incre(images, cfg)
    got = pooled_sharded.register_sequence_features_incre_sharded(
        images, cfg, mesh)
    assert [r.ok for r in got] == [r.ok for r in ref]
    assert [r.offset for r in got] == [r.offset for r in ref]
    assert [r.direction for r in got] == [r.direction for r in ref]


def test_sharded_incre_recovers_truth(seq):
    images, tl = seq
    mesh = make_mesh(8, axis="frames")
    recs = pooled_sharded.register_sequence_features_incre_sharded(
        images, _cfg(), mesh)
    for k, r in enumerate(recs):
        want = (tl[k + 1][0] - tl[k][0], tl[k + 1][1] - tl[k][1])
        assert r.ok, (k, want)
        assert abs(r.offset[0] - want[0]) <= 1
        assert abs(r.offset[1] - want[1]) <= 1


def test_sharded_whole_image_equals_unsharded(seq):
    images, _ = seq
    # linear subset (whole-image path has no direction search)
    images = images[:3]
    cfg = _cfg().replace(registration="feature")
    mesh = make_mesh(8, axis="frames")
    ref = freg.register_sequence_features(images, cfg)
    got = pooled_sharded.register_sequence_features_sharded(images, cfg, mesh)
    assert [r.ok for r in got] == [r.ok for r in ref]
    assert [r.offset for r in got] == [r.offset for r in ref]


def test_driver_mesh_panorama_equals_single_device(seq, tmp_path):
    """The ONE driver, end-to-end, mesh == single."""
    images, _ = seq
    cfg = _cfg()
    single = Stitcher(cfg).stitch_batch(
        __import__("imagestitch_tpu.io.dataset", fromlist=["ImageBatch"])
        .ImageBatch(gray=images, color=None, files=[str(i) for i in
                                                    range(len(images))]))
    mesh = make_mesh(8, axis="frames")
    sharded = Stitcher(cfg, mesh=mesh).stitch_batch(
        __import__("imagestitch_tpu.io.dataset", fromlist=["ImageBatch"])
        .ImageBatch(gray=images, color=None, files=[str(i) for i in
                                                    range(len(images))]))
    assert len(single) == len(sharded)
    for a, b in zip(single, sharded):
        assert a.file_range == b.file_range
        assert a.offsets == b.offsets
        # identical placement; fade blend is +-1 LSB between the scan-grouped
        # and shard_map executions (f32 scheduling; see test_compose_sharded)
        np.testing.assert_allclose(np.asarray(b.image).astype(int),
                                   np.asarray(a.image).astype(int), atol=1)
