"""The seeded scan generator: deterministic, true geometry, registrable."""
import numpy as np
import pytest

from imagestitch_tpu import StitchConfig
from imagestitch_tpu.core import feature_registration as freg
from imagestitch_tpu.eval import seeded_scan


def _small(seed):
    return seeded_scan.serpentine_scan(
        seed, n_frames=9, frame_shape=(256, 320), column_length=4,
        step=(180, 205), jitter=2, transition_col=(255, 270),
        transition_row=(-4, -1))


def test_deterministic_per_seed():
    a, b, c = _small(5), _small(5), _small(6)
    np.testing.assert_array_equal(a.origins, b.origins)
    np.testing.assert_array_equal(a.frames(), b.frames())
    np.testing.assert_array_equal(a.frame(3), a.frames([3])[0])
    assert not np.array_equal(a.frames([0]), c.frames([0]))


def test_flagship_geometry():
    """89 frames of 1936x2584 in columns of 15, serpentine: in-column
    steps 1660-1884 px with at most 3 px across, row transitions of about
    +2410 px, every offset an integer + 0.5 (no frame is rendered)."""
    scan = seeded_scan.serpentine_scan(0)
    assert scan.n_frames == 89 and scan.frame_shape == (1936, 2584)
    off = scan.true_offsets
    assert off.shape == (88, 2)
    np.testing.assert_array_equal(np.abs(off) % 1.0, 0.5)
    assert (scan.origins >= 0).all()
    for k, (dr, dc) in enumerate(off):
        if (k + 1) % 15 == 0:                     # to the next column
            assert 2405 <= dc <= 2479 and -16.5 <= dr <= -1.5
        else:
            down = ((k + 1) // 15) % 2 == 0
            assert 1660 <= abs(dr) <= 1885 and (dr > 0) == down
            assert abs(dc) <= 3.5
    np.testing.assert_array_equal(scan.expected_offsets, np.trunc(off))


def test_frames_overlap_consistently():
    """Adjacent frames see the same field: the overlap of frames 0 and 1
    (shifted by half a pixel) agrees far better than unrelated content."""
    scan = _small(7)
    f0, f1 = scan.frames([0, 1]).astype(np.float64)
    dr, dc = scan.expected_offsets[0]
    assert dr > 0
    a = f0[dr + 8:248, max(dc, 0) + 8:312 + min(dc, 0)]
    b = f1[8:248 - dr, 8 - min(dc, 0):312 - max(dc, 0)]
    same = np.abs(a - b).mean()
    other = np.abs(a - f1[-a.shape[0]:, -a.shape[1]:]).mean()
    assert same < other / 2


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_pool_registers_reduced_scan(seed):
    """The plain pool + replay recovers every offset of a reduced scan
    exactly (the truncated truth), serpentine turns included."""
    scan = _small(seed)
    cfg = StitchConfig(registration="feature_incre", direction=1,
                       direct_incre=1, roi_ratio=0.2, color_mode=False)
    recs = freg.register_sequence_features_incre(scan.frames(), cfg)
    assert all(r.ok for r in recs)
    got = np.asarray([r.offset for r in recs])
    np.testing.assert_array_equal(got, scan.expected_offsets)
    assert np.abs(got - scan.true_offsets).max() <= 1.0


def test_offset_pair():
    pair = seeded_scan.offset_pair(3, frame_shape=(64, 80), offset=(40, -2))
    np.testing.assert_array_equal(pair.true_offsets, [[40.5, -1.5]])
    np.testing.assert_array_equal(pair.expected_offsets, [[40, -1]])
    assert pair.frames().shape == (2, 64, 80)
