"""The zlib PNG codec behind io.codec when neither cv2 nor PIL exists."""
import struct
import zlib

import numpy as np
import pytest

from imagestitch_tpu.io import codec


@pytest.mark.parametrize("shape", [(37, 53), (20, 31, 3)])
def test_roundtrip(shape):
    img = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    np.testing.assert_array_equal(codec.png_decode(codec.png_encode(img)), img)


def _png(rows, filters, ctype=0, depth=8, interlace=0):
    h, w = rows.shape[:2]
    raw = b"".join(bytes([f]) + r.tobytes() for f, r in zip(filters, rows))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (codec._PNG_SIG + codec._png_chunk(b"IHDR", ihdr)
            + codec._png_chunk(b"IDAT", zlib.compress(raw))
            + codec._png_chunk(b"IEND", b""))


def test_sub_and_up_filters():
    img = np.random.default_rng(1).integers(0, 256, (4, 9), np.uint8)
    enc = img.copy()
    enc[1, 1:] = img[1, 1:] - img[1, :-1]           # Sub
    enc[2] = img[2] - img[1]                          # Up
    np.testing.assert_array_equal(
        codec.png_decode(_png(enc, [0, 1, 2, 0])), img)


@pytest.mark.parametrize("kw,match", [
    ({"filters": [4, 0]}, "row filter"),
    ({"depth": 16}, "bit depth"),
    ({"interlace": 1}, "interlace"),
])
def test_unsupported_variants_fail_loudly(kw, match):
    rows = np.zeros((2, 4), np.uint8)
    filters = kw.pop("filters", [0, 0])
    with pytest.raises(ValueError, match=match):
        codec.png_decode(_png(rows, filters, **kw))


def test_imread_imwrite_fall_back_without_cv2_or_pil(monkeypatch, tmp_path):
    monkeypatch.setattr(codec, "_HAS_CV2", False)
    monkeypatch.setattr(codec, "_HAS_PIL", False)
    bgr = np.random.default_rng(2).integers(0, 256, (6, 7, 3), np.uint8)
    path = str(tmp_path / "x.png")
    codec.imwrite(path, bgr)
    np.testing.assert_array_equal(codec.imread(path, color=True), bgr)
    np.testing.assert_array_equal(codec.imread(path, color=False),
                                  codec.to_gray(bgr))
    with pytest.raises(RuntimeError, match="no image encoder"):
        codec.imwrite(str(tmp_path / "x.jpg"), bgr)
