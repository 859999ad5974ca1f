"""Decode-overlapped ingest on seeded JPEG files (the demo-image tests in
test_prefetch.py need the reference's data; these need none)."""
import os

import numpy as np
import pytest

from imagestitch_tpu import StitchConfig, Stitcher
from imagestitch_tpu.core import feature_registration as freg
from imagestitch_tpu.eval import seeded_scan
from imagestitch_tpu.io import codec, dataset, prefetch


@pytest.fixture(scope="module")
def jpeg_files(tmp_path_factory):
    scan = seeded_scan.serpentine_scan(
        11, n_frames=6, frame_shape=(256, 320), column_length=3,
        step=(180, 205), jitter=2, transition_col=(255, 270),
        transition_row=(-4, -1))
    d = tmp_path_factory.mktemp("seeded") / "1"
    files = []
    for k, f in enumerate(scan.frames()):
        files.append(str(d / f"1-{k:03d}.jpg"))
        codec.imwrite(files[-1], f)
    return files


def test_chunk_prefetcher_covers_all_files(jpeg_files):
    chunks = list(prefetch.ChunkPrefetcher(jpeg_files, color_mode=False,
                                           chunk_frames=4))
    assert [c.num_images for c in chunks] == [4, 2]
    assert [f for c in chunks for f in c.files] == jpeg_files


def test_pipelined_registration_matches_direct(jpeg_files):
    cfg = StitchConfig(registration="feature_incre", direction=1,
                       direct_incre=1, roi_ratio=0.2, color_mode=False)
    recs_p, gray_dev, _ = prefetch.register_sequence_pipelined(
        jpeg_files, cfg, chunk_frames=2)
    batch = dataset.load_batch(jpeg_files, color_mode=False)
    recs = freg.register_sequence_features_incre(batch.gray, cfg)
    assert all(r.ok for r in recs)
    assert [r.offset for r in recs_p] == [r.offset for r in recs]
    np.testing.assert_array_equal(np.asarray(gray_dev), batch.gray)


def test_stream_output_feature_incre_gray(jpeg_files):
    """The flagship ingest keeps host frames for the streamed assembler;
    the f64 host composer agrees with the device default to 1 LSB."""
    cfg = StitchConfig(registration="feature_incre", direction=1,
                       direct_incre=1, roi_ratio=0.2, color_mode=False)
    base = Stitcher(cfg).stitch_files(jpeg_files)
    streamed = Stitcher(cfg.replace(stream_output=True)).stitch_files(
        jpeg_files)
    assert len(base) == len(streamed) == 1
    diff = np.abs(streamed[0].image.astype(np.int32)
                  - base[0].image.astype(np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-2
