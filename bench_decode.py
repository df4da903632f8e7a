"""Decode-parallelism benchmark: 4K H.264 frames/s vs reader-thread count.

Measures whether the GOP-parallel native reader
(`pyorc_tpu/io/native_decoder.py::ParallelVideoReader`, one FFmpeg decoder
instance per worker, GIL released inside vd_read) scales decode throughput
with host cores. The reference decodes strictly sequentially through cv2
(reference pyorc/api/video.py:136-211), so its decode rate is ~1 core
regardless of host size. Host decode only: no device is involved, and
``host_cores`` says how many cores the host offered.

Prints ONE JSON line.
"""

import json
import os
import tempfile
import time

from bench_e2e import FPS, synth_clip

SECONDS = 10.0


def measure(path: str, workers: int, n_frames: int) -> float:
    from pyorc_tpu.io.native_decoder import ParallelVideoReader

    rdr = ParallelVideoReader(path, workers=workers)
    try:
        # warm codec init + file cache outside the timed region
        rdr.read(0, 8, gray=True)
        # one read call for the whole clip: each worker seeks to ONE keyframe
        # and decodes its contiguous segment — the intended GOP-parallel
        # access pattern (chunked reads would pay a keyframe re-seek +
        # roll-forward per chunk and measure seek overhead, not decode)
        t0 = time.perf_counter()
        arr = rdr.read(0, n_frames, gray=True)
        dt = time.perf_counter() - t0
        assert arr.shape[0] == n_frames, arr.shape
    finally:
        rdr.close()
    return n_frames / dt


def main():
    n_frames = int(SECONDS * FPS)
    clip = os.path.join(tempfile.gettempdir(), f"pyorc_tpu_e2e_{int(SECONDS)}s_4k.mp4")
    if not os.path.isfile(clip):
        tmp = clip + ".tmp.mp4"
        synth_clip(tmp, n_frames)
        os.replace(tmp, clip)

    fps_by_threads = {}
    for w in (1, 2, 4):
        fps_by_threads[str(w)] = round(measure(clip, w, n_frames), 2)

    base = fps_by_threads["1"]
    result = {
        "metric": "decode_4k_fps_by_reader_threads",
        "value": fps_by_threads["4"],
        "unit": "frames/s",
        "speedup_4_over_1": round(fps_by_threads["4"] / base, 3) if base else None,
        "fps_by_threads": fps_by_threads,
        "host_cores": os.cpu_count(),
        "n_frames": n_frames,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
