"""Host-side video decode: the I/O pump feeding the device pipeline.

Decode stays on the CPU (OpenCV's C++ core via cv2, like the reference's
``cv2.VideoCapture`` usage at ``pyorc/api/video.py:136-211`` and
``pyorc/cv.py:876-990``); frames are handed to JAX in batches so device
compute overlaps the next batch's decode (see api.video.LazyFrames).
"""

from __future__ import annotations

import threading
from queue import Queue
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["color_scale", "get_frame", "get_time_frames", "get_rotation_code", "BatchPrefetcher"]


def get_rotation_code(rotation):
    """Degrees (0/90/180/270) -> OpenCV rotation code. Reference pyorc/helpers.py:245-268."""
    if rotation not in [0, 90, 180, 270, None]:
        raise ValueError(f"Rotation code must be in allowed codes 0, 90, 180 or 270. Provided code is {rotation}")
    if rotation in (0, None):
        return None
    import cv2

    if rotation == 90:
        return cv2.ROTATE_90_CLOCKWISE
    elif rotation == 180:
        return cv2.ROTATE_180
    elif rotation == 270:
        return cv2.ROTATE_90_COUNTERCLOCKWISE
    return None


def color_scale(img: np.ndarray, method: str) -> np.ndarray:
    """BGR frame -> requested color space. Reference pyorc/cv.py:834-873."""
    import cv2

    if method == "grayscale":
        return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    if method == "rgb":
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if method == "hsv":
        return cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    if method == "hue":
        return cv2.cvtColor(img, cv2.COLOR_BGR2HSV)[:, :, 0]
    if method == "sat":
        return cv2.cvtColor(img, cv2.COLOR_BGR2HSV)[:, :, 1]
    if method == "val":
        return cv2.cvtColor(img, cv2.COLOR_BGR2HSV)[:, :, 2]
    return img  # bgr


def warp_affine(img: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Stabilization warp. Reference pyorc/cv.py:549-571."""
    import cv2

    h, w = img.shape[0], img.shape[1]
    return cv2.warpAffine(img, np.asarray(m, dtype=np.float64)[:2], (w, h))


def get_frame(cap, rotation=None, ms=None, method: str = "grayscale"):
    """Read + rotate + stabilize + color-convert one frame. Reference pyorc/cv.py:876-920."""
    import cv2

    ret, img = cap.read()
    if ret and rotation is not None:
        img = cv2.rotate(img, rotation)
    if ret:
        if ms is not None:
            img = warp_affine(img, ms)
        img = color_scale(img, method)
    return ret, img


def _check_valid_frames(cap, frame_number: List[int]) -> Optional[int]:
    """Detect unreadable tail frames via direct seek. Reference pyorc/cv.py:25-61."""
    import cv2

    if not frame_number:
        return None
    last_valid = None
    idx = len(frame_number) - 1
    while idx >= 0:
        cap.set(cv2.CAP_PROP_POS_FRAMES, np.float64(frame_number[idx]))
        ret, img = cap.read()
        if ret and img is not None:
            last_valid = idx + 1
            break
        idx -= 1
    return last_valid


def get_time_frames(
    cap,
    start_frame: int,
    end_frame: int,
    lazy: bool = True,
    fps: Optional[float] = None,
    progress: bool = True,
    **kwargs,
) -> Tuple[list, list, Optional[list]]:
    """Scan valid timestamps/frame numbers (and frames when eager).

    Reference pyorc/cv.py:923-990: stops on non-advancing timestamps,
    trims unreadable tail frames.
    """
    import cv2
    from tqdm import tqdm

    cap.set(cv2.CAP_PROP_POS_FRAMES, np.float64(start_frame))
    pbar = tqdm(
        total=end_frame - start_frame + 1, position=0, desc="Scanning video", disable=not progress, leave=True
    )
    ret, img = get_frame(cap, **kwargs)
    n = start_frame
    time: list = []
    frame_number: list = []
    frames = None if lazy else []
    while ret:
        if n > end_frame:
            break
        if not lazy and frames is not None:
            frames.append(img)
        t1 = cap.get(cv2.CAP_PROP_POS_MSEC)
        time.append(n * 1000.0 / fps) if fps is not None else time.append(t1)
        frame_number.append(n)
        n += 1
        ret, img = get_frame(cap, **kwargs)
        pbar.update(1)
        if not ret:
            break
        t2 = cap.get(cv2.CAP_PROP_POS_MSEC)
        if t2 <= 0.0:
            break
    pbar.close()
    if lazy:
        last_valid_idx = _check_valid_frames(cap, frame_number)
        if last_valid_idx is not None:
            time = time[:last_valid_idx]
            frame_number = frame_number[:last_valid_idx]
    return time, frame_number, frames


class BatchPrefetcher:
    """Background-thread decode-ahead: overlap host decode with device compute.

    The reference relies on dask's thread pool for this (reference
    ``pyorc/api/video.py:479-491``); here a single decode thread keeps a
    bounded queue of upcoming batches full while the device works.
    """

    def __init__(self, batch_fn, batch_ranges, depth: int = 2):
        self._queue: Queue = Queue(maxsize=depth)
        self._ranges = list(batch_ranges)
        self._batch_fn = batch_fn
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for rng in self._ranges:
                self._queue.put(("ok", self._batch_fn(*rng)))
        except Exception as e:  # propagate to consumer
            self._queue.put(("err", e))
        self._queue.put(("done", None))

    def __iter__(self):
        while True:
            kind, item = self._queue.get()
            if kind == "done":
                return
            if kind == "err":
                raise item
            yield item
