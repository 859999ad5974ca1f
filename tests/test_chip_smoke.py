"""chip_smoke.py rehearsed on the CPU at a tiny size.

The script's phases take their devices explicitly, so the same functions
that run on the GPU run here on the virtual CPU devices: the default device
stands in for the GPU and another CPU device for the reference.  The
script itself must refuse to run without a GPU.
"""
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from imagestitch_tpu.eval import seeded_scan  # noqa: E402

_CARD = "cpu rehearsal"
_MARGIN = 80        # clear of the tiny scan's <= 76 px overlaps


@pytest.fixture(scope="module")
def tiny():
    scan = seeded_scan.serpentine_scan(
        3, n_frames=10, frame_shape=(256, 320), column_length=4,
        step=(180, 205), jitter=2, transition_col=(255, 270),
        transition_row=(-4, -1))
    return scan, scan.frames()


def test_check_platform_rejects_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_platform(jax.devices())


def test_main_fails_before_any_result_without_gpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_phase_flagship_and_pool(tiny):
    scan, frames = tiny
    res = chip_smoke.phase_flagship(scan, frames, chip_smoke.flagship_config(),
                                    _CARD, _MARGIN)
    assert [tuple(o) for o in res[0].offsets] == \
        [tuple(o) for o in scan.expected_offsets]
    per = chip_smoke.phase_pool_profile(frames[:4], chip_smoke.flagship_config(),
                                        _CARD, repeats=1)
    assert per > 0


def test_phase_reference_on_another_device(tiny):
    _, frames = tiny
    chip_smoke.phase_reference(frames[:6], chip_smoke.flagship_config(),
                               jax.devices()[1])


def test_phase_phase_corr():
    pair = seeded_scan.offset_pair(4, frame_shape=(256, 320), offset=(210, 2))
    chip_smoke.phase_phase_corr(pair, jax.devices()[1])


def test_phase_cli(tiny):
    _, frames = tiny
    chip_smoke.phase_cli(frames[:5], chip_smoke.flagship_config(), "cpu")


def test_phase_mesh(tiny):
    scan, frames = tiny
    chip_smoke.phase_mesh(scan, frames, chip_smoke.flagship_config(), 4,
                          _CARD, _MARGIN)


def test_check_flagship_catches_a_wrong_offset(tiny):
    scan, frames = tiny
    res = chip_smoke.stitch(frames, chip_smoke.flagship_config())
    res[0].offsets[2] = (res[0].offsets[2][0] + 2, res[0].offsets[2][1])
    with pytest.raises(AssertionError, match="off by more than 1 px"):
        chip_smoke.check_flagship(res, scan, frames, _MARGIN)


def test_compare_panoramas_bound():
    a = np.zeros((100, 200), np.uint8)
    b = a.copy()
    b[0, 0] = 1                      # 1 LSB on 5e-5 of pixels: inside
    assert chip_smoke.compare_panoramas(a, b, "t") == (1, 5e-5)
    b[0, 1] = 1                      # 1e-4 still inside, 1.5e-4 outside
    b[0, 2] = 1
    with pytest.raises(AssertionError, match="beyond"):
        chip_smoke.compare_panoramas(a, b, "t")
    with pytest.raises(AssertionError, match="shapes"):
        chip_smoke.compare_panoramas(a, b[:, :10], "t")
