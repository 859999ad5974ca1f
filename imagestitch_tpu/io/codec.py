"""Host-side image decode/encode.

This is the framework's host<->device boundary layer — the equivalent of
the reference's numpy<->cv::Mat bridge (reference:
appendix/conversion.cpp:1-262).  Decode happens on the host (JPEG/PNG via
OpenCV when present, PIL otherwise, and 8-bit PNG through ``zlib`` when
neither is installed); arrays are handed to JAX as uint8 batches and all
further compute is on-device.

Byte-level reading mirrors the reference's non-ASCII-path-tolerant decode
(reference: Stitcher.py:68-69 uses imdecode(np.fromfile(...))) by always
reading bytes first.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

try:  # pragma: no cover - environment probe
    import cv2  # type: ignore

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False

try:  # pragma: no cover - environment probe
    from PIL import Image  # type: ignore

    _HAS_PIL = True
except Exception:  # pragma: no cover
    Image = None
    _HAS_PIL = False


def imread(path: str, color: bool) -> np.ndarray:
    """Decode an image file.

    Returns uint8 ``(H, W)`` when ``color`` is False, else ``(H, W, 3)`` in
    **BGR** channel order (reference parity: the reference composes and writes
    with OpenCV's BGR convention, Stitcher.py:382).
    """
    data = np.fromfile(path, dtype=np.uint8)
    if _HAS_CV2:
        flag = cv2.IMREAD_COLOR if color else cv2.IMREAD_GRAYSCALE
        img = cv2.imdecode(data, flag)
        if img is None:
            raise IOError(f"failed to decode image: {path}")
        return img
    if _HAS_PIL:
        import io as _io

        with Image.open(_io.BytesIO(data.tobytes())) as im:
            if color:
                arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
                return arr[..., ::-1].copy()  # RGB -> BGR
            # PIL 'L' uses ITU-R 601-2; close to cv2's grayscale weights.
            return np.asarray(im.convert("L"), dtype=np.uint8)
    if _is_png(path):
        img = png_decode(data.tobytes())
        if color:
            return img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
        return to_gray(img)
    raise RuntimeError("no image decoder available for "
                       f"{path} (need cv2 or PIL)")


def imwrite(path: str, image: np.ndarray) -> None:
    """Encode and write an image (BGR for color input)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = np.clip(image, 0, 255).astype(np.uint8)
    if _HAS_CV2:
        ok = cv2.imwrite(path, image)
        if not ok:
            raise IOError(f"failed to write image: {path}")
        return
    if _HAS_PIL:
        if image.ndim == 3:
            Image.fromarray(image[..., ::-1]).save(path)
        else:
            Image.fromarray(image).save(path)
        return
    if _is_png(path):
        with open(path, "wb") as f:
            f.write(png_encode(image))
        return
    raise RuntimeError("no image encoder available for "
                       f"{path} (need cv2 or PIL)")


def _is_png(path: str) -> bool:
    return os.path.splitext(path)[1].lower() == ".png"


_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def png_encode(image: np.ndarray) -> bytes:
    """8-bit grey (H, W) or BGR (H, W, 3) uint8 -> PNG bytes (filter 0)."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w = image.shape[:2]
    if image.ndim == 3:
        image = np.ascontiguousarray(image[..., ::-1])   # BGR -> RGB
    rows = image.reshape(h, -1)
    raw = np.hstack([np.zeros((h, 1), np.uint8), rows]).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if image.ndim == 3 else 0,
                       0, 0, 0)
    return (_PNG_SIG + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def png_decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) grey or (H, W, 3) BGR uint8.

    Handles what ``png_encode`` writes and a little more: 8-bit grey or RGB,
    not interlaced, row filters None, Sub and Up.  Anything else raises
    ValueError rather than decoding wrongly.
    """
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in (0, 2) or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace} (only 8-bit grey "
                         "or RGB, not interlaced)")
    bpp = 3 if ctype == 2 else 1
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    filters, rows = raw[:, 0], raw[:, 1:].copy()
    if np.any(filters > 2):
        raise ValueError(f"unsupported PNG row filter {filters.max()} "
                         "(only None, Sub and Up)")
    for i in np.nonzero(filters)[0]:
        if filters[i] == 1:    # Sub: running sum per channel, mod 256
            px = rows[i].reshape(w, bpp)
            rows[i] = np.cumsum(px, axis=0, dtype=np.uint8).reshape(-1)
        elif i > 0:            # Up: add the reconstructed row above
            rows[i] += rows[i - 1]
    if bpp == 1:
        return rows.reshape(h, w)
    return np.ascontiguousarray(rows.reshape(h, w, 3)[..., ::-1])


def to_gray(image: np.ndarray) -> np.ndarray:
    """BGR uint8 -> grayscale uint8 with OpenCV's rounding convention."""
    if image.ndim == 2:
        return image
    b = image[..., 0].astype(np.float32)
    g = image[..., 1].astype(np.float32)
    r = image[..., 2].astype(np.float32)
    return np.clip(np.round(0.114 * b + 0.587 * g + 0.299 * r), 0, 255).astype(np.uint8)
