"""Host pipeline parallelism: decode-overlapped registration."""
import os

import numpy as np
import pytest

from conftest import REFERENCE_DEMO, has_demo_images
from imagestitch_tpu import StitchConfig
from imagestitch_tpu.core import feature_registration as freg
from imagestitch_tpu.io import dataset, prefetch

pytestmark = pytest.mark.skipif(not has_demo_images(),
                                reason="reference demoImages not present")


def test_chunk_prefetcher_covers_all_files():
    files = dataset.list_project_images(
        os.path.join(REFERENCE_DEMO, "zirconBSE"), 1)
    chunks = list(prefetch.ChunkPrefetcher(files, color_mode=False,
                                           chunk_frames=3))
    assert sum(c.num_images for c in chunks) == len(files)
    got = [f for c in chunks for f in c.files]
    assert got == files


def test_pipelined_registration_matches_direct():
    files = dataset.list_project_images(
        os.path.join(REFERENCE_DEMO, "zirconBSE"), 1)
    cfg = StitchConfig(registration="feature_incre", direction=4,
                       direct_incre=0, roi_ratio=0.2)
    recs_p, gray_dev, _ = prefetch.register_sequence_pipelined(
        files, cfg, chunk_frames=2)
    batch = dataset.load_batch(files, color_mode=False)
    recs = freg.register_sequence_features_incre(batch.gray, cfg)
    assert [r.offset for r in recs_p] == [r.offset for r in recs]
    assert [r.ok for r in recs_p] == [r.ok for r in recs]
    assert gray_dev.shape == batch.gray.shape
    np.testing.assert_array_equal(np.asarray(gray_dev), batch.gray)
