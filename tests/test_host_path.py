"""Host-side pieces of the main path: the compile-cache rule, the numpy
polygon fill behind the ortho mean maps, and the main path with the optional
packages (cv2, tqdm) absent."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "custom"], ids=["unset", "set"])
def test_compile_cache_placement(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = "import jax, pyorc_tpu.ops; print(jax.config.jax_compilation_cache_dir)"
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    want = str(tmp_path / env_dir) if env_dir else os.path.join(ROOT, ".jax_cache")
    assert out.stdout.strip().splitlines()[-1] == want


def _polygons():
    rng = np.random.default_rng(17)
    h, w = 90, 140
    polys = []
    # convex quadrilateral like a camera-space AOI
    c = np.array([70.0, 45.0])
    ang = np.sort(rng.uniform(0, 2 * np.pi, 4))
    polys.append(np.round(c + np.c_[np.cos(ang), np.sin(ang)] * rng.uniform(25, 40, (4, 1))))
    # concave star
    t = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    r = np.where(np.arange(12) % 2 == 0, 40.0, 15.0)
    polys.append(np.round(np.c_[70 + r * np.cos(t), 45 + r * np.sin(t)]))
    # self-intersecting random ring
    polys.append(np.c_[rng.integers(0, w, 7), rng.integers(0, h, 7)].astype(float))
    # many-vertex ring (the AOI ring is densified to hundreds of points)
    t = np.linspace(0, 2 * np.pi, 300, endpoint=False)
    polys.append(np.round(np.c_[70 + 60 * np.cos(t) + 5 * np.sin(5 * t), 45 + 38 * np.sin(t)]))
    return (h, w), polys


@pytest.mark.parametrize("k", range(4), ids=["quad", "star", "selfcross", "dense"])
def test_fill_polygon_matches_cv2(k):
    cv2 = pytest.importorskip("cv2")
    from pyorc_tpu.geom.shapes import fill_polygon

    shape, polys = _polygons()
    ring = polys[k].astype(np.int32)
    want = np.zeros(shape, np.uint8)
    cv2.fillPoly(want, [ring], 1)
    got = fill_polygon(shape, ring)
    assert got.dtype == bool and got.any()
    assert np.array_equal(got, want == 1)


@pytest.fixture
def no_optional(monkeypatch):
    """cv2 and tqdm absent: importing either raises ImportError."""
    for name in ("cv2", "tqdm"):
        monkeypatch.setitem(sys.modules, name, None)


def _nadir(h=120, w=160):
    import pyorc_tpu

    res = 0.01
    src = [[10, 10], [w - 10, 10], [w - 10, h - 10], [10, h - 10]]
    cc = pyorc_tpu.CameraConfig(
        height=h, width=w, resolution=res, window_size=16,
        gcps={"src": src, "dst": [[res * c, res * (h - r)] for c, r in src], "h_ref": 0.0, "z_0": 0.0},
        camera_matrix=[[500.0, 0.0, w / 2], [0.0, 500.0, h / 2], [0.0, 0.0, 1.0]],
        dist_coeffs=[[0.0]] * 5,
    )
    cc.set_bbox_from_corners([[15, 15], [w - 15, 15], [w - 15, h - 15], [15, h - 15]])
    return cc


def _frames(n=5, h=120, w=160):
    from test_piv import make_particle_image, shift_image

    img = make_particle_image(np.random.default_rng(3), h, w, n_particles=600)
    img = img / img.max() * 200 + 20
    return np.stack([shift_image(img, 1.5 * t, -0.5 * t) for t in range(n)]).clip(0, 255).astype(np.uint8)


def test_project_without_cv2_or_tqdm(no_optional):
    import chip_smoke

    da = chip_smoke.frames_dataarray(_frames(), _nadir())
    proj = da.frames.project()
    assert proj.shape[0] == 5 and np.isfinite(np.asarray(proj.values, float)).all()


def test_get_piv_without_cv2_or_tqdm(no_optional, monkeypatch):
    import chip_smoke

    monkeypatch.setenv("PYORC_TPU_SHARD", "0")
    proj = chip_smoke.frames_dataarray(_frames(), _nadir()).frames.project()
    ds = proj.frames.get_piv(window_size=16)
    assert ds["v_x"].shape[0] == 4
    assert np.isfinite(ds["v_x"].values).mean() > 0.5


def test_video_without_cv2_or_tqdm(tmp_path, no_optional):
    from pyorc_tpu.io import native_decoder

    if not native_decoder.encoder_available():
        pytest.skip("the native FFmpeg decoder is not built on this machine")
    import pyorc_tpu

    frames = _frames(n=6)
    fn = str(tmp_path / "clip.mp4")
    with native_decoder.NativeVideoWriter(fn, 160, 120, fps=10.0, channels=1, crf=12) as wr:
        for f in frames:
            wr.write(f)
    video = pyorc_tpu.Video(fn, camera_config=_nadir(), start_frame=0, end_frame=5, h_a=0.0)
    assert (video.height, video.width) == (120, 160)
    # the container's frame rate as FFmpeg (and cv2) report it
    assert video.fps == native_decoder.NativeVideoReader(fn).fps
    da = video.get_frames()
    assert da.shape == (len(video.frame_number), 120, 160)
    assert np.abs(np.asarray(da.data[0], float) - frames[0]).mean() < 3.0
