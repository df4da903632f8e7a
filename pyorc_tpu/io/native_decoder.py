"""ctypes bindings for the native FFmpeg decode pump (native/decoder.cpp).

The shared library is built from ``native/decoder.cpp`` alone with
``make -C native``, on first use when it is missing or older than the source
(a stale build is never loaded). Where it cannot be built (no compiler or no
FFmpeg development files) :func:`available` is False and callers decode with
cv2.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_LIB = None
_LIB_LOCK = threading.Lock()
_BUILD_TRIED = False


def _native_dir() -> Path:
    return Path(__file__).resolve().parent.parent.parent / "native"


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _BUILD_TRIED
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        so = _native_dir() / "libpyorc_decoder.so"
        src = _native_dir() / "decoder.cpp"
        stale = not so.is_file() or so.stat().st_mtime < src.stat().st_mtime
        if stale:
            if _BUILD_TRIED:
                return None
            _BUILD_TRIED = True
            try:
                subprocess.run(
                    ["make", "-C", str(_native_dir())],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.vd_open.restype = ctypes.c_void_p
        lib.vd_open.argtypes = [ctypes.c_char_p]
        lib.vd_meta.restype = ctypes.c_int
        lib.vd_meta.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vd_read.restype = ctypes.c_int64
        lib.vd_read.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.vd_close.restype = None
        lib.vd_close.argtypes = [ctypes.c_void_p]
        lib.vd_timestamps.restype = ctypes.c_int64
        lib.vd_timestamps.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        # H.264 encoder (ve_*) — older prebuilt libraries may lack it
        if hasattr(lib, "ve_open"):
            lib.ve_open.restype = ctypes.c_void_p
            lib.ve_open.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_double,
                ctypes.c_int,
                ctypes.c_int,
            ]
            lib.ve_write.restype = ctypes.c_int
            lib.ve_write.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
            lib.ve_close.restype = ctypes.c_int
            lib.ve_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


class NativeVideoReader:
    """Sequential/seekable frame reader over the native decoder."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native decoder unavailable")
        self._lib = lib
        self._handle = lib.vd_open(path.encode())
        if not self._handle:
            raise IOError(f"native decoder could not open {path}")
        fps = ctypes.c_double()
        n = ctypes.c_int64()
        w = ctypes.c_int()
        h = ctypes.c_int()
        lib.vd_meta(self._handle, ctypes.byref(fps), ctypes.byref(n), ctypes.byref(w), ctypes.byref(h))
        self.fps = fps.value
        self.frame_count = int(n.value)
        self.width = int(w.value)
        self.height = int(h.value)
        self._lock = threading.Lock()

    def read(self, start: int, count: int, gray: bool = True) -> np.ndarray:
        """Decode frames [start, start+count) -> uint8 [count, H, W(, 3)]."""
        ch = 1 if gray else 3
        out = np.empty((count, self.height, self.width * ch), dtype=np.uint8)
        with self._lock:
            got = self._lib.vd_read(
                self._handle,
                int(start),
                int(count),
                1 if gray else 0,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
        if got < count:
            out = out[: max(int(got), 0)]
        if gray:
            return out
        return out.reshape(-1, self.height, self.width, 3)

    def timestamps(self) -> Optional[np.ndarray]:
        """Per-frame presentation times in ms (packet scan, no decoding)."""
        cap = max(self.frame_count * 2, 1024)
        out = np.empty(cap, dtype=np.float64)
        with self._lock:
            n = self._lib.vd_timestamps(
                self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap
            )
        if n <= 0:
            return None
        return out[:n].copy()

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.vd_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ParallelVideoReader:
    """GOP-parallel batch decode: N workers each seek to a keyframe and decode
    a contiguous segment (one FFmpeg decoder instance per worker, GIL released
    inside vd_read). This is what makes faster-than-realtime ingest possible
    for 4K sources, where single-stream decode is the end-to-end bottleneck
    (reference decode is a strictly sequential cv2 loop,
    reference pyorc/api/video.py:136-211).
    """

    def __init__(self, path: str, workers: int = 4):
        if not available():
            raise RuntimeError("native decoder unavailable")
        self._path = path
        self._workers = max(int(workers), 1)
        self._readers = [NativeVideoReader(path) for _ in range(self._workers)]
        r0 = self._readers[0]
        self.fps = r0.fps
        self.frame_count = r0.frame_count
        self.width = r0.width
        self.height = r0.height

    def read(self, start: int, count: int, gray: bool = True) -> np.ndarray:
        import concurrent.futures as cf

        n_seg = min(self._workers, max(count, 1))
        bounds = np.linspace(start, start + count, n_seg + 1).astype(int)
        segs = [(int(a), int(b - a)) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]

        def work(i, s0, cnt):
            return i, self._readers[i].read(s0, cnt, gray=gray)

        out = [None] * len(segs)
        with cf.ThreadPoolExecutor(max_workers=len(segs)) as ex:
            futs = [ex.submit(work, i, s0, cnt) for i, (s0, cnt) in enumerate(segs)]
            for f in futs:
                i, arr = f.result()
                out[i] = arr
        return np.concatenate(out, axis=0)

    def close(self):
        for r in self._readers:
            r.close()
        self._readers = []

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def encoder_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "ve_open")


class NativeVideoWriter:
    """H.264 (libx264) mp4 writer over the native library.

    Replaces the reference's cv2.VideoWriter (reference
    pyorc/api/frames.py:537-607) for `Frames.to_video`, and produces the
    synthetic videos for the velocity-parity harness (a real H.264
    round-trip keeps decoding in the loop).
    """

    def __init__(self, path: str, width: int, height: int, fps: float = 25.0,
                 channels: int = 1, crf: int = 18):
        lib = _load()
        if lib is None or not hasattr(lib, "ve_open"):
            raise RuntimeError("native encoder unavailable")
        self._lib = lib
        self._channels = 3 if channels == 3 else 1
        self._shape = (height, width) if self._channels == 1 else (height, width, 3)
        self._handle = lib.ve_open(path.encode(), int(width), int(height), float(fps),
                                   self._channels, int(crf))
        if not self._handle:
            raise IOError(f"native encoder could not open {path}")

    def write(self, frame: np.ndarray) -> None:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.shape != self._shape:
            raise ValueError(f"frame shape {frame.shape} != {self._shape}")
        rc = self._lib.ve_write(self._handle, frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise IOError(f"native encoder write failed (rc={rc})")

    def close(self) -> None:
        if self._handle:
            rc = self._lib.ve_close(self._handle)
            self._handle = None
            if rc != 0:
                raise IOError(f"native encoder close failed (rc={rc})")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
