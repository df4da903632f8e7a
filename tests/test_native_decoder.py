"""Native FFmpeg decode pump: cv2 agreement, seek consistency, Video wiring.

The native decoder (native/decoder.cpp via pyorc_tpu.io.native_decoder) is the
batch decode fast path, replacing the reference's per-frame
cv2.VideoCapture loop (reference pyorc/api/video.py:136-211). These tests are
skipped when FFmpeg dev libraries / a compiler are unavailable.
"""

import numpy as np
import pytest

from pyorc_tpu.io import native_decoder

GEUL_MP4 = "/root/reference/examples/geul/dk_control.mp4"

pytestmark = pytest.mark.skipif(not native_decoder.available(), reason="native decoder not built")


@pytest.fixture(scope="module")
def reader():
    import os

    if not os.path.isfile(GEUL_MP4):
        pytest.skip("geul example video unavailable")
    r = native_decoder.NativeVideoReader(GEUL_MP4)
    yield r
    r.close()


def test_metadata(reader):
    import cv2

    cap = cv2.VideoCapture(GEUL_MP4)
    assert reader.width == int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    assert reader.height == int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    assert abs(reader.fps - cap.get(cv2.CAP_PROP_FPS)) < 0.01
    assert abs(reader.frame_count - int(cap.get(cv2.CAP_PROP_FRAME_COUNT))) <= 1
    cap.release()


def test_gray_matches_cv2(reader):
    """Gray frames agree with cv2's decode+cvtColor to ~1 LSB.

    Small residuals remain because cv2 wheels bundle their own swscale build;
    the conversion pipeline (BGR24 bicubic + fixed-point gray weights) is
    identical, so disagreement stays within interpolation rounding.
    """
    import cv2

    g = reader.read(0, 6, gray=True)
    assert g.shape == (6, reader.height, reader.width)
    cap = cv2.VideoCapture(GEUL_MP4)
    ref = np.stack([cv2.cvtColor(cap.read()[1], cv2.COLOR_BGR2GRAY) for _ in range(6)])
    cap.release()
    diff = np.abs(g.astype(int) - ref.astype(int))
    assert diff.mean() < 1.5
    assert np.percentile(diff, 99) <= 8


def test_rgb_matches_cv2(reader):
    import cv2

    rgb = reader.read(0, 2, gray=False)
    assert rgb.shape == (2, reader.height, reader.width, 3)
    cap = cv2.VideoCapture(GEUL_MP4)
    ref = np.stack([cap.read()[1][:, :, ::-1] for _ in range(2)])
    cap.release()
    diff = np.abs(rgb.astype(int) - ref.astype(int))
    assert diff.mean() < 2.0


def test_seek_consistency(reader):
    """Random access returns the same pixels as sequential decode."""
    seq = reader.read(0, 12, gray=True)
    direct = reader.read(8, 4, gray=True)
    assert np.array_equal(direct, seq[8:12])
    # seek backwards again
    direct0 = reader.read(2, 3, gray=True)
    assert np.array_equal(direct0, seq[2:5])


def test_read_past_end(reader):
    n = reader.frame_count
    out = reader.read(n - 2, 10, gray=True)
    assert 1 <= out.shape[0] <= 3  # only the real tail comes back


def test_video_uses_native_path(monkeypatch):
    """Video._decode_frames routes through the native pump and matches cv2."""
    import os

    if not os.path.isfile(GEUL_MP4):
        pytest.skip("geul example video unavailable")
    from pyorc_tpu.api.video import Video

    vid = Video(GEUL_MP4, start_frame=0, end_frame=8, progress=False)
    native = vid._decode_frames(np.arange(4), "grayscale")
    assert vid._native_reader is not None
    monkeypatch.setenv("PYORC_TPU_NATIVE_DECODE", "0")
    vid2 = Video(GEUL_MP4, start_frame=0, end_frame=8, progress=False)
    ref = vid2._decode_frames(np.arange(4), "grayscale")
    assert vid2._native_reader is None
    assert native.shape == ref.shape
    assert np.abs(native.astype(int) - ref.astype(int)).mean() < 1.5
    # strided positions (freq>1) decode the span and subsample
    strided = vid._decode_frames(np.array([1, 3, 5]), "grayscale")
    ref_s = vid2._decode_frames(np.array([1, 3, 5]), "grayscale")
    assert strided.shape == ref_s.shape
    assert np.abs(strided.astype(int) - ref_s.astype(int)).mean() < 1.5


def test_video_pickle_drops_native_handle():
    import os
    import pickle

    if not os.path.isfile(GEUL_MP4):
        pytest.skip("geul example video unavailable")
    from pyorc_tpu.api.video import Video

    vid = Video(GEUL_MP4, start_frame=0, end_frame=4, progress=False)
    _ = vid._native_reader
    vid2 = pickle.loads(pickle.dumps(vid))
    frames = vid2._decode_frames(np.arange(2), "grayscale")
    assert frames.shape[0] == 2


def test_seek_exact_on_vfr_metadata():
    """Seek-started segments are bit-identical to sequential decode even when
    the container's metadata frame rate doesn't match real frame spacing
    (the pts index, not pts*fps, numbers the frames)."""
    path = "/root/reference/examples/camera_calib/camera_calib_720p.mkv"
    import os

    if not os.path.isfile(path):
        pytest.skip("calibration video unavailable")
    ref = native_decoder.NativeVideoReader(path).read(0, 100, gray=True)
    r = native_decoder.NativeVideoReader(path)
    for s0 in (90, 37, 61):
        seg = r.read(s0, 3, gray=True)
        assert np.array_equal(seg, ref[s0 : s0 + 3]), f"seek to {s0} misaligned"
    r.close()


def test_parallel_reader_matches_sequential():
    path = "/root/reference/examples/camera_calib/camera_calib_720p.mkv"
    import os

    if not os.path.isfile(path):
        pytest.skip("calibration video unavailable")
    ref = native_decoder.NativeVideoReader(path).read(0, 60, gray=True)
    pr = native_decoder.ParallelVideoReader(path, workers=3)
    assert pr.frame_count > 0 and pr.width == 1280
    a = pr.read(0, 60, gray=True)
    b = pr.read(0, 60, gray=True)  # reuse re-seeks every segment
    pr.close()
    assert np.array_equal(a, ref)
    assert np.array_equal(b, ref)
