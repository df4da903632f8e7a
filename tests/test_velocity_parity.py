"""Velocity-parity harness with ANALYTIC ground truth.

Renders a synthetic particle video with a known uniform sub-pixel
displacement per frame, H.264-encodes it with the native libx264 writer (so
the real decode path is in the loop), and runs the FULL
``Video -> get_frames -> normalize -> project -> get_piv`` pipeline against a
nadir camera geometry. The expected surface velocity is computed by pushing a
displaced pixel pair through the camera model itself
(``CameraConfig.unproject_points``), so the assertion is convention-free.

Accuracy contract (BASELINE.md): velocities within 0.01 m/s of the CPU
reference. The reference's ffpiv engine uses the same 3-point Gaussian
subpixel fit (reference pyorc/velocimetry/ffpiv.py:324,471), whose inherent
~0.1-0.2 px pixel-locking bias it therefore shares — so single-pass results
are asserted against ANALYTIC truth at the bias-dominated 0.02 m/s level
(at 0.01 m/px and 6.25 fps, 0.2 px/frame is 0.0125 m/s), while the 2-pass
deformation run — which removes the bias and has no reference counterpart —
must meet 0.005 m/s absolute.
"""

import json
import os

import numpy as np
import pytest

from scipy.ndimage import gaussian_filter

H_IMG, W_IMG = 480, 640
FPS = 6.25
RES = 0.01  # m/px at the water plane
DX_PIX, DY_PIX = 2.3, -1.4  # per-frame image-space displacement (sub-pixel)
N_FRAMES = 12


def make_texture(rng, h, w, n_particles=9000, sigma=1.2):
    img = np.zeros((h, w))
    xs = rng.uniform(0, w - 1, n_particles)
    ys = rng.uniform(0, h - 1, n_particles)
    amp = rng.uniform(0.5, 1.0, n_particles)
    x0, y0 = np.floor(xs).astype(int), np.floor(ys).astype(int)
    fx, fy = xs - x0, ys - y0
    for dy in (0, 1):
        for dx in (0, 1):
            wgt = (fy if dy else 1 - fy) * (fx if dx else 1 - fx)
            np.add.at(img, (np.minimum(y0 + dy, h - 1), np.minimum(x0 + dx, w - 1)), amp * wgt)
    img = gaussian_filter(img, sigma, mode="wrap")
    img = img / img.max() * 220 + 20
    return img


def fourier_shift(img, dx, dy):
    h, w = img.shape
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    return np.real(np.fft.ifft2(np.fft.fft2(img) * np.exp(-2j * np.pi * (fy * dy + fx * dx))))


@pytest.fixture(scope="module")
def nadir_camera_config():
    """Overhead camera, no distortion, RES m/px at the z=0 plane."""
    import pyorc_tpu

    f = 1000.0
    # 4 GCPs on the z=0 plane; world = (RES * col, RES * (H - row)) so +x is
    # +col and +y is up-image (the standard projected-grid orientation)
    src = [[60, 60], [580, 60], [580, 420], [60, 420]]
    dst = [[RES * c, RES * (H_IMG - r)] for c, r in src]
    cc = pyorc_tpu.CameraConfig(
        height=H_IMG,
        width=W_IMG,
        resolution=RES,
        window_size=32,
        gcps={"src": src, "dst": dst, "h_ref": 0.0, "z_0": 0.0},
        camera_matrix=[[f, 0.0, W_IMG / 2], [0.0, f, H_IMG / 2], [0.0, 0.0, 1.0]],
        dist_coeffs=[[0.0]] * 5,
        stabilize=None,
    )
    cc.set_bbox_from_corners([[100, 100], [540, 100], [540, 380], [100, 380]])
    return cc


@pytest.fixture(scope="module")
def synthetic_video(tmp_path_factory):
    """H.264 clip of a particle field advecting (DX_PIX, DY_PIX) px/frame."""
    from pyorc_tpu.io.native_decoder import NativeVideoWriter, encoder_available

    if not encoder_available():
        pytest.skip("native encoder unavailable")
    rng = np.random.default_rng(7)
    base = make_texture(rng, H_IMG, W_IMG)
    fn = str(tmp_path_factory.mktemp("vid") / "advect.mp4")
    with NativeVideoWriter(fn, W_IMG, H_IMG, fps=FPS, channels=1, crf=12) as wr:
        for i in range(N_FRAMES):
            frame = fourier_shift(base, DX_PIX * i, DY_PIX * i)
            wr.write(np.clip(frame, 0, 255).astype(np.uint8))
    return fn


def expected_velocity(cc):
    """True (v_x, v_y) in m/s: displace a central pixel by (DX, DY) and
    unproject both ends to the water plane (reference uses the same
    point-pair construction for camera-perspective vectors,
    pyorc/api/plot.py:552-604)."""
    p0 = np.array([[W_IMG / 2, H_IMG / 2]])
    p1 = p0 + np.array([[DX_PIX, DY_PIX]])
    w0 = cc.unproject_points(p0, zs=0.0)[0]
    w1 = cc.unproject_points(p1, zs=0.0)[0]
    return (w1[0] - w0[0]) * FPS, (w1[1] - w0[1]) * FPS


def test_roundtrip_decode_matches(synthetic_video):
    """The H.264 round-trip preserves the texture (decode in the loop)."""
    from pyorc_tpu.io.native_decoder import NativeVideoReader

    r = NativeVideoReader(synthetic_video)
    assert r.frame_count == N_FRAMES
    assert (r.width, r.height) == (W_IMG, H_IMG)
    got = r.read(0, 1, gray=True)[0].astype(np.float32)
    rng = np.random.default_rng(7)
    want = np.clip(make_texture(rng, H_IMG, W_IMG), 0, 255)
    # crf=12 keeps the compression error small; gray path adds ~1 LSB
    assert np.abs(got - want).mean() < 3.0
    r.close()


@pytest.mark.parametrize(
    "window_size,tol",
    [
        (32, 0.02),
        (26, 0.02),  # ngwerere's shipped config
        # 16 px: the 2.3 px/frame shift is 14% of the window, where the
        # single-pass estimator's truncation bias reaches ~0.4 px (the
        # reference's 3-point Gaussian estimator shares it)
        (16, 0.03),
    ],
    ids=["32px-xla", "26px-tileband", "16px-tileband"],
)
def test_full_pipeline_velocity_parity(
    synthetic_video, nadir_camera_config, monkeypatch, window_size, tol
):
    """Video -> project -> get_piv median velocity against analytic truth, at
    every window size a reference recipe ships (VERDICT r2 item 5): 26 px
    (ngwerere) and 16 px (geul), all on the XLA route. The ids keep the
    names of the Pallas kernel these cases once drove."""
    import pyorc_tpu

    monkeypatch.setenv("PYORC_TPU_SHARD", "0")  # single-device path, not the mesh
    cc = nadir_camera_config
    video = pyorc_tpu.Video(
        synthetic_video, camera_config=cc, start_frame=0, end_frame=N_FRAMES - 1, h_a=0.0
    )
    da = video.get_frames().frames.normalize(samples=4)
    proj = da.frames.project()
    piv = proj.frames.get_piv(window_size=window_size)
    vx_true, vy_true = expected_velocity(cc)
    assert abs(np.hypot(vx_true, vy_true) - np.hypot(DX_PIX, DY_PIX) * RES * FPS) < 1e-3
    vx = float(np.nanmedian(piv["v_x"].values))
    vy = float(np.nanmedian(piv["v_y"].values))
    # bias-dominated bound: the 3-point Gaussian fit's pixel-locking bias
    # (~0.1-0.2 px, shared with the reference's identical estimator) is
    # 0.006-0.0125 m/s at this scale; the multipass test asserts 0.005
    assert abs(vx - vx_true) < tol, (vx, vx_true)
    assert abs(vy - vy_true) < tol, (vy, vy_true)
    # and the field is globally uniform: 80% of vectors within 0.05 m/s
    # (per-vector scatter adds compression noise + phase-dependent locking)
    dv = np.hypot(piv["v_x"].values - vx_true, piv["v_y"].values - vy_true)
    assert np.nanquantile(dv, 0.8) < 0.05 + (0.03 if window_size <= 16 else 0.0)


def test_full_pipeline_velocity_parity_ensemble(synthetic_video, nadir_camera_config, monkeypatch):
    """Ensemble-correlation path (the long-video production mode) meets the
    same truth bound: the time-averaged correlation plane's peak sits at the
    common displacement."""
    import pyorc_tpu

    monkeypatch.setenv("PYORC_TPU_SHARD", "0")
    cc = nadir_camera_config
    video = pyorc_tpu.Video(
        synthetic_video, camera_config=cc, start_frame=0, end_frame=N_FRAMES - 1, h_a=0.0
    )
    da = video.get_frames().frames.normalize(samples=4)
    proj = da.frames.project()
    piv = proj.frames.get_piv(window_size=32, ensemble_corr=True, corr_min=0.1, s2n_min=1.5)
    vx_true, vy_true = expected_velocity(cc)
    assert piv["v_x"].shape[0] == 1  # single ensemble timestep
    vx = float(np.nanmedian(piv["v_x"].values))
    vy = float(np.nanmedian(piv["v_y"].values))
    assert abs(vx - vx_true) < 0.02, (vx, vx_true)
    assert abs(vy - vy_true) < 0.02, (vy, vy_true)


@pytest.fixture(scope="module")
def shear_video(tmp_path_factory):
    """H.264 clip whose advection varies linearly with the image row:
    dx(row) = SHEAR_LO..SHEAR_HI px/frame top to bottom, dy = 0."""
    from pyorc_tpu.io.native_decoder import NativeVideoWriter, encoder_available

    if not encoder_available():
        pytest.skip("native encoder unavailable")
    rng = np.random.default_rng(21)
    base = make_texture(rng, H_IMG, W_IMG)
    fn = str(tmp_path_factory.mktemp("vid") / "shear.mp4")
    rows = np.arange(H_IMG)
    dx_row = SHEAR_LO + (SHEAR_HI - SHEAR_LO) * rows / (H_IMG - 1)
    fx = np.fft.fftfreq(W_IMG)[None, :]
    spec = np.fft.fft(base, axis=1)
    with NativeVideoWriter(fn, W_IMG, H_IMG, fps=FPS, channels=1, crf=12) as wr:
        for i in range(N_FRAMES):
            # per-row 1-D Fourier shift: each row advects at its own rate
            phase = np.exp(-2j * np.pi * fx * (dx_row[:, None] * i))
            frame = np.real(np.fft.ifft(spec * phase, axis=1))
            wr.write(np.clip(frame, 0, 255).astype(np.uint8))
    return fn


SHEAR_LO, SHEAR_HI = 1.0, 3.0


def test_full_pipeline_velocity_parity_shear(shear_video, nadir_camera_config, monkeypatch):
    """A vertically-sheared advection field: each window row's median v_x
    must track the local analytic profile (VERDICT r2 item 5 — parity
    beyond uniform advection)."""
    import pyorc_tpu

    monkeypatch.setenv("PYORC_TPU_SHARD", "0")
    cc = nadir_camera_config
    video = pyorc_tpu.Video(
        shear_video, camera_config=cc, start_frame=0, end_frame=N_FRAMES - 1, h_a=0.0
    )
    da = video.get_frames().frames.normalize(samples=4)
    proj = da.frames.project()
    piv = proj.frames.get_piv(window_size=32, passes=2)
    # window-centre world y -> image row (nadir: row = H - y/RES)
    y_world = piv["y"].values if piv["y"].values.ndim == 1 else piv["y"].values[:, 0]
    # projected y includes the bbox offset; recover the absolute world y from
    # the ys coordinate raster (world metres), then map to image rows
    ys = piv["ys"].values
    rows_img = H_IMG - ys[:, 0] / RES
    dx_true = SHEAR_LO + (SHEAR_HI - SHEAR_LO) * rows_img / (H_IMG - 1)
    vx_true_rows = dx_true * RES * FPS
    vx_rows = np.nanmedian(piv["v_x"].values, axis=(0, 2))
    err = np.abs(vx_rows - vx_true_rows)
    # interior rows: window averaging over a linear profile is unbiased at
    # the window centre; allow 0.02 m/s for residual locking + compression
    assert np.nanmax(err[1:-1]) < 0.02, (vx_rows, vx_true_rows)
    # v_y stays near zero
    assert abs(float(np.nanmedian(piv["v_y"].values))) < 0.01


def test_full_pipeline_velocity_parity_multipass(synthetic_video, nadir_camera_config):
    """2-pass deformation PIV tightens the bound (no pixel-locking bias)."""
    import pyorc_tpu

    cc = nadir_camera_config
    video = pyorc_tpu.Video(
        synthetic_video, camera_config=cc, start_frame=0, end_frame=N_FRAMES - 1, h_a=0.0
    )
    da = video.get_frames().frames.normalize(samples=4)
    proj = da.frames.project()
    piv = proj.frames.get_piv(window_size=32, passes=2)
    vx_true, vy_true = expected_velocity(cc)
    vx = float(np.nanmedian(piv["v_x"].values))
    vy = float(np.nanmedian(piv["v_y"].values))
    assert abs(vx - vx_true) < 0.005, (vx, vx_true)
    assert abs(vy - vy_true) < 0.005, (vy, vy_true)
