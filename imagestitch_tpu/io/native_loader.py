"""ctypes bridge to the native runtime (native/stitch_runtime.cpp).

This is the framework's equivalent of the reference's C++ bridge layer
(reference: appendix/conversion.cpp numpy<->Mat), reoriented for
accelerator use: the native side produces exactly the contiguous uint8
batch that crosses the host->device boundary, decoded by a thread pool
instead of the reference's serial per-image cv2.imdecode (Stitcher.py:68-69,
:400-403).

Builds with make on first use, into ``native/build/<key>/``, where the key
hashes the sources and what ``-march=native`` means to this host's
compiler: a library built on another kind of CPU, or from other sources,
is never loaded.  Degrades to the pure-Python decoder when the toolchain
or libjpeg is unavailable.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_NAME = "libstitch_runtime.so"

_lock = threading.Lock()
_lib = None
_tried = False
_error: Optional[str] = None     # why the runtime is unavailable


def so_path() -> Optional[str]:
    """Where this host's build of the current sources lives; None without
    a C++ compiler."""
    h = hashlib.sha256()
    for name in ("stitch_runtime.cpp", "Makefile"):
        with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
            h.update(f.read())
    try:
        target = subprocess.run(
            [os.environ.get("CXX", "g++"), "-march=native", "-Q",
             "--help=target"], check=True, capture_output=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        global _error
        _error = f"no usable C++ compiler: {e}"
        return None
    h.update(target.stdout)
    key = f"{platform.machine()}-{h.hexdigest()[:16]}"
    return os.path.join(_NATIVE_DIR, "build", key, _SO_NAME)


def _build(path: str) -> bool:
    """Compile to a private name, then rename: concurrent processes never
    load a half-written library."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, f"OUT={tmp}"], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        global _error
        err = getattr(e, "stderr", b"") or b""
        _error = f"build failed: {e} {err.decode(errors='replace')[-300:]}"
        return False
    os.replace(tmp, path)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native runtime; None if unavailable."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = so_path()
        if path is None or (not os.path.exists(path) and not _build(path)):
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.isr_version.restype = ctypes.c_int
            if lib.isr_version() != 3:
                _error = f"{path}: version {lib.isr_version()}, want 3"
                return None
            lib.isr_has_jpeg.restype = ctypes.c_int
            lib.isr_probe.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
            lib.isr_probe.restype = ctypes.c_int
            lib.isr_load_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int]
            lib.isr_load_batch.restype = ctypes.c_int
            lib.isr_bgr_to_gray.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int, ctypes.c_int]
            lib.isr_paste.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
            i16p = ctypes.POINTER(ctypes.c_int16)
            f64p = ctypes.POINTER(ctypes.c_double)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_longlong)
            lib.isr_blend_rect.argtypes = [
                i16p, i16p, u8p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                f64p, f64p, f64p, f64p, ctypes.c_int, ctypes.c_int]
            lib.isr_paste16.argtypes = [
                i16p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int]
            lib.isr_rect_stats.argtypes = [
                i16p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                i64p, i32p, i32p, i64p]
            lib.isr_fuse_step.argtypes = [
                i16p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                f64p, f64p, f64p, f64p, ctypes.c_int, ctypes.c_int]
            lib.isr_fill16.argtypes = [i16p, ctypes.c_longlong,
                                       ctypes.c_int16, ctypes.c_int]
            lib.isr_finalize16.argtypes = [i16p, u8p, ctypes.c_longlong,
                                           ctypes.c_int]
            _lib = lib
        except OSError as e:
            _error = f"load failed: {e}"
            return None
        return _lib


def unavailable_reason() -> Optional[str]:
    """Why ``get_lib()`` returned None (None while it has not)."""
    return _error


def _is_jpeg(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in (".jpg", ".jpeg")


def has_jpeg() -> bool:
    """Whether the native runtime exists and was built with libjpeg."""
    lib = get_lib()
    return lib is not None and lib.isr_has_jpeg() == 1


class NativeLoader:
    """Thread-pool JPEG batch loader with the ``read_all`` protocol expected
    by io.dataset.load_batch."""

    def __init__(self, threads: Optional[int] = None):
        self.threads = threads or max(2, os.cpu_count() or 2)

    def available(self) -> bool:
        return has_jpeg()

    def read_all(self, files: Sequence[str], color: bool) -> List[np.ndarray]:
        lib = get_lib()
        if not has_jpeg() or not all(_is_jpeg(f) for f in files):
            from . import codec
            return [codec.imread(f, color) for f in files]
        h = ctypes.c_int()
        w = ctypes.c_int()
        rc = lib.isr_probe(files[0].encode(), ctypes.byref(h), ctypes.byref(w))
        if rc != 0:
            raise IOError(f"failed to probe {files[0]} (rc={rc})")
        n = len(files)
        shape = (n, h.value, w.value, 3) if color else (n, h.value, w.value)
        out = np.empty(shape, np.uint8)
        arr = (ctypes.c_char_p * n)(*[f.encode() for f in files])
        rc = lib.isr_load_batch(
            arr, n, 1 if color else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            h.value, w.value, self.threads)
        if rc != 0:
            raise IOError(f"native decode failed for {files[rc - 1]}")
        return list(out)


def probe_dims(path: str) -> Optional[tuple]:
    """(H, W) of an image from its header — no full decode."""
    lib = get_lib()
    if has_jpeg() and _is_jpeg(path):
        h = ctypes.c_int()
        w = ctypes.c_int()
        if lib.isr_probe(path.encode(), ctypes.byref(h),
                         ctypes.byref(w)) == 0:
            return (h.value, w.value)
    try:
        import cv2
        im = cv2.imread(path, 0)
        if im is not None:
            return im.shape[:2]
    except Exception:
        pass
    return None


def blend_rect_native(a: np.ndarray, b: np.ndarray,
                      war: np.ndarray, wac: np.ndarray,
                      wbr: np.ndarray, wbc: np.ndarray,
                      mode: int) -> Optional[np.ndarray]:
    """Threaded double-precision separable-weight rect blend (C kernel).

    ``a``/``b``: (H, W[, C]) int16 canvas rects (before / after paste);
    weight factor vectors are float64 of lengths H / W.  Returns the uint8
    fused rect, or None when the native runtime is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    h, w = a.shape[:2]
    c = a.shape[2] if a.ndim == 3 else 1
    a = np.ascontiguousarray(a, np.int16)
    b = np.ascontiguousarray(b, np.int16)
    war = np.ascontiguousarray(war, np.float64)
    wac = np.ascontiguousarray(wac, np.float64)
    wbr = np.ascontiguousarray(wbr, np.float64)
    wbc = np.ascontiguousarray(wbc, np.float64)
    out = np.empty(a.shape, np.uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.isr_blend_rect(
        a.ctypes.data_as(i16p), b.ctypes.data_as(i16p),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, c,
        war.ctypes.data_as(f64p), wac.ctypes.data_as(f64p),
        wbr.ctypes.data_as(f64p), wbc.ctypes.data_as(f64p),
        int(mode), 0)
    return out


def bgr_to_gray_native(bgr: np.ndarray) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    h, w = bgr.shape[:2]
    bgr = np.ascontiguousarray(bgr)
    gray = np.empty((h, w), np.uint8)
    lib.isr_bgr_to_gray(bgr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        h, w)
    return gray
