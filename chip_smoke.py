"""Smoke test of the video-to-discharge path on an NVIDIA GPU.

Drives the main path once through the entry points a user calls, at real
sizes, on frames made from a seed, and checks what comes out:

0. device: JAX must find a GPU; prints its kind, the card's name and power
   limit (nvidia-smi), XLA_FLAGS and the compile-cache directory;
1. station clip: 65 frames of 1920x1080 at 25 fps of a particle texture
   advected at a known speed, seen by an oblique (30 degrees off nadir),
   distorted camera: normalize -> project -> get_piv(26 px) -> mask chain ->
   get_transect -> get_q -> get_river_flow. The median speed must be within
   2 % of the truth and the median discharge positive and within 5 % of a
   host-side integral over the same transect;
2. survey clip: 33 frames of 3840x2160 under a nadir camera:
   normalize -> project -> get_piv(64 px, ensemble); speed within 2 %;
3. reference comparison: per-pair PIV at 16/26/32/64 px with both
   correlation methods and the 26 px ensemble scan against the float64 NumPy
   reference (pyorc_tpu.ops.piv_reference), and 2-pass PIV at 32 px on the
   station frames against the known shift;
4. timings: every phase cold (first call, compilation included) and warm,
   peak device memory, and the fft and matmul per-pair and ensemble rates on
   1088x1920 frames, from which ops.piv's GPU correlation method is chosen.

Frames enter at ``Frames`` from in-memory arrays: the machine with the card
has no FFmpeg development files, so the native decoder behind
``pyorc_tpu.Video`` is not built there.

Usage::

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # only the sharded paths, on four GPUs

The last line of standard output is one JSON object with the device; every
finding is printed on the lines before it. The script exits non-zero and
prints no result when JAX finds no GPU or any check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from bench import card_info, require_gpu

FPS = 25.0
CONFIDENT_GAP = 5e-3  # windows whose top-two plane values differ by more
PLANE_TOL = 1e-4  # planes are in [0, 1]; fp32 FFT error ~1e-6, TF32 ~1e-3
PX_TOL = 0.01  # |du|, |dv| on confident windows


def say(*parts):
    print(*parts, flush=True)


def check(ok, what):
    """Fail the run (exit status 1, no result line) unless ``ok``; unlike
    ``assert`` this survives ``python -O``."""
    if not ok:
        raise SystemExit(f"chip_smoke: {what}")


def run_twice(name, fn, timings):
    """Run ``fn`` cold then warm; record both wall times; return the cold
    result. Every phase returns host arrays, and turning a device array
    into one waits for the device, so each time ends with the device idle."""
    t0 = time.perf_counter()
    out = fn()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn()
    warm = time.perf_counter() - t0
    timings[name] = (cold, warm)
    return out


def peak_bytes() -> int:
    import jax

    return int(jax.devices()[0].memory_stats().get("peak_bytes_in_use", -1))


# -- synthetic scenes -----------------------------------------------------------


def particle_texture(rng, h, w, density=0.05, sigma=1.0):
    """Float32 texture of Gaussian particles on a dark background, in [0, 1]."""
    from scipy.ndimage import gaussian_filter

    img = np.zeros((h, w), np.float32)
    n = int(h * w * density)
    img[rng.integers(0, h, n), rng.integers(0, w, n)] = rng.uniform(0.5, 1.0, n)
    img = gaussian_filter(img, sigma, mode="wrap")
    return img / img.max()


def render(texture, rows, cols, shift_rows, shift_cols, n_frames):
    """uint8 frames [n, *rows.shape] sampling ``texture`` (bilinear) at
    (rows - t * shift_rows, cols - t * shift_cols) for t = 0..n-1, on the
    default device: the pattern moves by +shift per frame."""
    import jax
    import jax.numpy as jnp

    tex = jnp.asarray(texture)
    r = jnp.asarray(rows, jnp.float32)
    c = jnp.asarray(cols, jnp.float32)

    @jax.jit
    def frame(t):
        v = jax.scipy.ndimage.map_coordinates(
            tex, [r - t * shift_rows, c - t * shift_cols], order=1, mode="constant"
        )
        return (20.0 + 215.0 * v).astype(jnp.uint8)

    return np.stack([np.asarray(frame(float(t))) for t in range(n_frames)])


def particle_pair(rng, h, w, n_frames, shift):
    """Float32 particle frames [n, h, w], each Fourier-shifted by ``shift``
    (dx, dy) px from the one before."""
    base = particle_texture(rng, h, w, density=0.03, sigma=1.2).astype(np.float64) * 200.0
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    spec = np.fft.fft2(base)
    return np.stack([
        np.real(np.fft.ifft2(spec * np.exp(-2j * np.pi * t * (fy * shift[1] + fx * shift[0]))))
        for t in range(n_frames)
    ]).astype(np.float32)


def frames_dataarray(frames, cc, fps=FPS, h_a=0.0):
    """A frames DataArray as ``Video.get_frames`` builds one, from memory."""
    from pyorc_tpu import const, ndx

    t, h, w = frames.shape
    y = np.flipud(np.arange(h)).astype(np.float64)
    x = np.arange(w).astype(np.float64)
    xp, yp = np.meshgrid(x, y)
    coords = {"time": np.arange(t) / fps, "y": y, "x": x}
    attrs = {
        "camera_shape": str([h, w]),
        "camera_config": cc.to_json(),
        "h_a": json.dumps(h_a),
        "chunksize": 20,
    }
    da = ndx.DataArray(frames, dims=("time", "y", "x"), coords=coords, attrs=attrs, name="frames")
    da = da.frames.add_xy_coords({"xp": xp, "yp": yp}, coords, const.PERSPECTIVE_ATTRS)
    da.name = "frames"
    return da


def station_camera(h=1080, w=1920, res=0.02):
    """Oblique camera 12 m above the water, 30 degrees off nadir, looking
    toward +y, with Brown-Conrady distortion; GCPs and AOI from its pose."""
    from scipy.spatial.transform import Rotation

    import pyorc_tpu
    from pyorc_tpu.geom import camera as cam

    f = 1663.0 * w / 1920
    k = [[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]]
    dist = [[-0.08], [0.02], [0.001], [-0.0005], [0.0]]
    tilt = np.deg2rad(30.0)
    # rows: camera x (image right), y (image down), z (view) in world axes
    rot = np.array([[1.0, 0.0, 0.0], [0.0, -np.cos(tilt), -np.sin(tilt)], [0.0, np.sin(tilt), -np.cos(tilt)]])
    rvec = Rotation.from_matrix(rot).as_rotvec()
    tvec = -rot @ np.array([0.0, 0.0, 12.0])
    dst = np.array([[-3.0, 5.0], [3.0, 5.0], [3.0, 10.0], [-3.0, 10.0]])
    src = cam.project_points(np.c_[dst, np.zeros(4)], rvec, tvec, np.array(k), np.array(dist))
    cc = pyorc_tpu.CameraConfig(
        height=h, width=w, resolution=res, window_size=26,
        gcps={"src": src.tolist(), "dst": dst.tolist(), "h_ref": 0.0, "z_0": 0.0},
        camera_matrix=k, dist_coeffs=dist, stabilize=None,
    )
    cc.set_bbox_from_corners([[0.2 * w, 0.3 * h], [0.8 * w, 0.3 * h], [0.8 * w, 0.92 * h], [0.2 * w, 0.92 * h]])
    return cc


def grid_displacement(cc, v_world, dt):
    """True (u, v) in projected-grid pixels per frame for world velocity v."""
    t = tuple(cc.transform)  # x = t0 col + t1 row + t2, y = t3 col + t4 row + t5
    m = np.array([[t[0], t[1]], [t[3], t[4]]])
    dcol, drow = np.linalg.solve(m, np.asarray(v_world) * dt)
    return dcol, -drow


def speed_error(piv, v_true):
    speed = np.hypot(piv["v_x"].values, piv["v_y"].values)
    med = float(np.nanmedian(speed))
    return med, med / float(np.hypot(*v_true)) - 1.0


# -- phases -----------------------------------------------------------------------


def station_phase(timings, h=1080, w=1920, n_frames=65, v_world=(2.5, -1.5), res=0.02, seed=1):
    """Phase 1; returns the projected frames for the multipass check.

    The default flow moves (5, 3) grid pixels per frame. At whole pixels the
    3-point Gaussian fit has no peak-locking error and bilinear window
    deformation no interpolation bias (both belong to the method, and the
    reference engine shares the first), so the bounds measure the pipeline;
    phase 3 checks sub-pixel accuracy against the reference. At half a pixel
    per frame along rows, 2-pass PIV on these frames reads 0.07 px long."""
    cc = station_camera(h, w, res)
    rng = np.random.default_rng(seed)
    speed = float(np.hypot(*v_world))
    # world texture (texels of half a grid cell) over the AOI plus the advection
    texel = res / 2
    bx = np.asarray(cc.bbox.exterior.coords)
    margin = speed * n_frames / FPS + 1.0
    x0, y0 = bx[:, 0].min() - margin, bx[:, 1].min() - margin
    x1, y1 = bx[:, 0].max() + margin, bx[:, 1].max() + margin
    tex = particle_texture(rng, int((y1 - y0) / texel), int((x1 - x0) / texel), density=0.02, sigma=1.0)
    cols, rows = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    world = cc.unproject_points(np.c_[cols.ravel(), rows.ravel()], 0.0)
    tex_r = ((world[:, 1] - y0) / texel).reshape(h, w)
    tex_c = ((world[:, 0] - x0) / texel).reshape(h, w)
    frames = render(tex, tex_r, tex_c, v_world[1] / FPS / texel, v_world[0] / FPS / texel, n_frames)
    da = frames_dataarray(frames, cc)

    def pipeline():
        proj = da.frames.normalize().frames.project()
        piv = proj.frames.get_piv(window_size=26)
        masked = piv.copy(deep=True)
        masked.velocimetry.mask.minmax(inplace=True, s_min=0.1, s_max=2 * speed)
        masked.velocimetry.mask.outliers(inplace=True, tolerance=3.0)
        masked.velocimetry.mask.corr(inplace=True, tolerance=0.3)
        masked.velocimetry.mask.count(inplace=True, tolerance=0.33)
        return proj, piv, masked

    proj, piv, masked = run_twice("station", pipeline, timings)
    med, err = speed_error(masked, v_world)
    valid = float(np.isfinite(masked["v_x"].values).mean())
    say(f"station: {n_frames} frames {w}x{h}, grid {proj.shape[1:]}, piv {piv['v_x'].shape}, "
        f"valid after masks {valid:.3f}, median speed {med:.4f} m/s vs {speed:.4f} "
        f"(error {100 * err:+.3f} %)")
    check(valid > 0.5, "station: too few vectors survive the mask chain")
    check(abs(err) <= 0.02, "station: median speed off by more than 2 %")

    # transect across the flow, left bank to right bank looking downstream
    centre = np.asarray(cc.bbox.centroid.coords)[0][:2]
    flow = np.asarray(v_world) / speed
    left = np.array([-flow[1], flow[0]])
    half = 0.35 * min(np.ptp(bx[:, 0]), np.ptp(bx[:, 1]))
    s = np.linspace(-1.0, 1.0, 41)
    xs, ys = (centre[:, None] - half * left[:, None] * s[None, :])
    d_max = 1.5
    zs = -d_max * (1.0 - s**2)
    tr = masked.velocimetry.get_transect(xs, ys, zs, wdw=1)
    tr = tr.transect.get_q(fill_method="interpolate")
    tr.transect.get_river_flow()
    q_all = tr["river_flow"].values
    q_med = float(q_all[list(tr["quantile"].values).index(0.5)])
    # host integral of alpha * v * depth along the same line (alpha = get_q's
    # v_corr; the line is normal to the flow, so v is the full speed)
    fine = np.linspace(-half, half, 2001)
    depth = d_max * (1.0 - (fine / half) ** 2)
    q_ref = 0.9 * speed * float(np.sum((depth[1:] + depth[:-1]) / 2 * np.diff(fine)))
    q_err = q_med / q_ref - 1.0
    say(f"station: discharge median {q_med:.4f} m3/s vs host integral {q_ref:.4f} "
        f"(error {100 * q_err:+.3f} %), quantiles {np.round(q_all, 4).tolist()}")
    check(q_med > 0, "station: discharge is not positive")
    check(abs(q_err) <= 0.05, "station: discharge off the host integral by more than 5 %")
    return proj, cc, v_world


def survey_phase(timings, n_frames=33, d_px=(7.6, -3.1), seed=2):
    from bench_e2e import FPS as SURVEY_FPS, nadir_config

    cc = nadir_config()
    h, w = cc.height, cc.width
    rng = np.random.default_rng(seed)
    pad = 320
    tex = particle_texture(rng, h + 2 * pad, w + 2 * pad, density=0.02, sigma=1.0)
    cols, rows = np.meshgrid(np.arange(w, dtype=np.float32) + pad, np.arange(h, dtype=np.float32) + pad)
    frames = render(tex, rows, cols, d_px[1], d_px[0], n_frames)
    da = frames_dataarray(frames, cc, fps=SURVEY_FPS)
    p0 = np.array([[w / 2, h / 2]])
    v_true = (cc.unproject_points(p0 + np.array([d_px]), 0.0)[0] - cc.unproject_points(p0, 0.0)[0])[:2] * SURVEY_FPS

    def pipeline():
        proj = da.frames.normalize().frames.project()
        return proj.frames.get_piv(window_size=64, ensemble_corr=True)

    piv = run_twice("survey", pipeline, timings)
    med, err = speed_error(piv, v_true)
    say(f"survey: {n_frames} frames {w}x{h}, piv {piv['v_x'].shape}, median speed {med:.4f} m/s "
        f"vs {np.hypot(*v_true):.4f} (error {100 * err:+.3f} %)")
    check(abs(err) <= 0.02, "survey: median speed off by more than 2 %")


def compare_reference(h=1088, w=1920, windows=(16, 26, 32, 64), methods=("fft", "matmul"),
                      n_ens=9, ens_window=26, shift=(2.3, -1.4), seed=3):
    """Phase 3 (per pair and ensemble); returns the worst errors per case
    and fails the run when a tolerance is exceeded."""
    from pyorc_tpu.ops import piv, piv_reference, windows as win

    frames = particle_pair(np.random.default_rng(seed), h, w, n_ens, shift)
    worst = {}
    for ws in windows:
        sas, ov = (ws, ws), (ws // 2, ws // 2)
        n_rows, n_cols = win.get_field_shape((h, w), sas, ov)
        ref = piv_reference.corr_planes(frames[0], frames[1], ws, ws // 2)
        confident = piv_reference.peak_gap(ref) > CONFIDENT_GAP
        u_ref, v_ref = piv_reference.displacement(ref)
        for m in methods:
            _, _, planes = piv.cross_corr(frames[:2], sas, ov, corr_method=m)
            d_plane = float(np.abs(np.asarray(planes)[0].reshape(ref.shape) - ref).max())
            u, v, _, _ = piv.piv_pairs_strips(frames[:2], (h, w), sas, ov, n_rows, n_cols, None, m)
            du = float(np.abs(np.asarray(u)[0] - u_ref)[confident].max())
            dv = float(np.abs(np.asarray(v)[0] - v_ref)[confident].max())
            worst[f"pair {ws}px {m}"] = (d_plane, du, dv, float(confident.mean()))
    sas, ov = (ens_window, ens_window), (ens_window // 2, ens_window // 2)
    n_rows, n_cols = win.get_field_shape((h, w), sas, ov)
    cs_ref, cnt_ref, cmax_ref, s2n_ref = piv_reference.ensemble(frames, ens_window, ens_window // 2)
    # windows with a plane at a gate's edge may flip between float32 and float64
    marginal = ((np.abs(cmax_ref - 0.2) < 1e-3) | (np.abs(s2n_ref - 3.0) < 3e-3)).any(axis=0)
    with np.errstate(invalid="ignore"):
        mean_ref = cs_ref / cnt_ref[..., None, None]
    use = ~marginal & (cnt_ref > 0)
    confident = use & (piv_reference.peak_gap(np.nan_to_num(mean_ref)) > CONFIDENT_GAP)
    u_ref, v_ref = piv_reference.displacement(np.nan_to_num(mean_ref))
    for m in methods:
        cs, cnt, _, _ = piv.piv_ensemble_scan(frames, (h, w), sas, ov, n_rows, n_cols, corr_method=m)
        cnt = np.asarray(cnt).reshape(n_rows, n_cols)
        check(np.array_equal(cnt[~marginal], cnt_ref[~marginal]), f"ensemble {m}: gate counts differ")
        with np.errstate(invalid="ignore"):
            mean = np.asarray(cs).reshape(mean_ref.shape) / cnt[..., None, None]
        d_plane = float(np.abs(mean - mean_ref)[use].max())
        u, v = piv_reference.displacement(np.nan_to_num(mean))
        du = float(np.abs(u - u_ref)[confident].max())
        dv = float(np.abs(v - v_ref)[confident].max())
        worst[f"ensemble {ens_window}px {m}"] = (d_plane, du, dv, float(confident.mean()))
    for k, (d_plane, du, dv, frac) in worst.items():
        say(f"reference {k}: max |plane| {d_plane:.3e} (tol {PLANE_TOL}), max |du| {du:.4f} "
            f"|dv| {dv:.4f} px (tol {PX_TOL}) on {100 * frac:.1f} % confident windows")
        check(d_plane <= PLANE_TOL and du <= PX_TOL and dv <= PX_TOL, f"reference {k} out of tolerance")
    return worst


def multipass_check(proj, cc, v_world, timings, n_frames=9):
    u_true, v_true = grid_displacement(cc, v_world, 1.0 / FPS)
    sub = proj.isel(time=slice(0, n_frames))
    piv = run_twice("multipass", lambda: sub.frames.get_piv(window_size=32, passes=2), timings)
    scale = cc.resolution * FPS
    u = float(np.nanmedian(piv["v_x"].values)) / scale
    v = float(np.nanmedian(piv["v_y"].values)) / scale
    say(f"multipass 32 px, 2 passes: median (u, v) ({u:.4f}, {v:.4f}) px vs true "
        f"({u_true:.4f}, {v_true:.4f})")
    check(abs(u - u_true) <= 0.05 and abs(v - v_true) <= 0.05, "multipass off by more than 0.05 px")


def rates(h=1088, w=1920, n_frames=33, windows=(16, 26, 32, 64), reps=5):
    """Pairs/s of the per-pair program and the ensemble scan, per window and
    correlation method, on device-made frames; timed to block_until_ready."""
    import jax
    import jax.numpy as jnp

    from pyorc_tpu.ops import piv, windows as win

    frames = jax.random.uniform(jax.random.PRNGKey(0), (n_frames, h, w), jnp.float32, 0, 255)
    out = {}
    for ws in windows:
        sas, ov = (ws, ws), (ws // 2, ws // 2)
        n_rows, n_cols = win.get_field_shape((h, w), sas, ov)
        for m in ("fft", "matmul"):
            for kind, fn in (
                ("pair", lambda: piv.piv_pairs(frames, (h, w), sas, ov, n_rows, n_cols, None, m)),
                ("ensemble", lambda: piv.piv_ensemble_scan(frames, (h, w), sas, ov, n_rows, n_cols, corr_method=m)),
            ):
                t0 = time.perf_counter()
                jax.block_until_ready(fn())
                cold = time.perf_counter() - t0
                ts = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    jax.block_until_ready(fn())
                    ts.append(time.perf_counter() - t0)
                out[(kind, ws, m)] = (cold, float(np.median(ts)), min(ts))
    return out, n_frames - 1


def four_phase(h=1080, w=1920, n=33):
    """The sharded paths on four devices against device 0 alone."""
    import jax
    from jax.sharding import Mesh

    from bench_e2e import nadir_config
    from pyorc_tpu import parallel
    from pyorc_tpu.ops import piv, windows as win

    devices = jax.devices()
    if len(devices) != 4:
        raise SystemExit(f"chip_smoke --four: needs 4 GPUs, JAX found {len(devices)}")
    sas, ov = (32, 32), (16, 16)
    rng = np.random.default_rng(4)
    pad = 160
    tex = particle_texture(rng, h + 2 * pad, w + 2 * pad, density=0.03, sigma=1.0)
    cols, rows = np.meshgrid(np.arange(w, dtype=np.float32) + pad, np.arange(h, dtype=np.float32) + pad)
    with jax.default_device(devices[0]):
        frames = render(tex, rows, cols, -1.3, 2.4, n).astype(np.float32)
        n_rows, n_cols = win.get_field_shape((h, w), sas, ov)
        single = [np.asarray(a) for a in piv.piv_pairs_strips(frames, (h, w), sas, ov, n_rows, n_cols)]
        ens1 = [np.asarray(a) for a in piv.piv_ensemble_scan(frames, (h, w), sas, ov, n_rows, n_cols)]
    timings = {}
    pairs4 = run_twice("four pairs_sharded", lambda: parallel.piv_pairs_sharded(frames, sas, ov), timings)
    ens4 = run_twice("four ensemble_sharded", lambda: parallel.piv_ensemble_sharded(frames, sas, ov), timings)
    mesh2d = Mesh(np.asarray(devices).reshape(2, 2), ("pairs", "rows"))
    pairs2d = run_twice("four pairs_sharded_2d", lambda: parallel.piv_pairs_sharded_2d(frames, sas, ov, mesh=mesh2d), timings)
    checks = {}
    for name, out in (("pairs_sharded", pairs4), ("pairs_sharded_2d", pairs2d)):
        checks[name] = max(float(np.nanmax(np.abs(a - b))) for a, b in zip(out[:3], single[:3]))
    checks["ensemble_sharded corr_sum rel"] = float(np.abs(ens4[0] - ens1[0]).max() / np.abs(ens1[0]).max())
    checks["ensemble_sharded count"] = float(np.abs(ens4[1] - ens1[1]).max())

    cc = nadir_config(h, w)
    proj = frames_dataarray(frames.astype(np.uint8), cc).frames.project()
    piv4 = run_twice("four get_piv", lambda: proj.frames.get_piv(window_size=32), timings)
    os.environ["PYORC_TPU_SHARD"] = "0"
    with jax.default_device(devices[0]):
        piv1 = proj.frames.get_piv(window_size=32)
    del os.environ["PYORC_TPU_SHARD"]
    checks["get_piv 4 vs 1 device (m/s)"] = float(np.nanmax(np.abs(piv4["v_x"].values - piv1["v_x"].values)))
    for k, (cold, warm) in timings.items():
        say(f"timing {k}: cold {cold:.3f} s, warm {warm:.3f} s")
    for k, val in checks.items():
        say(f"four-device check {k}: {val:.3e}")
    check(checks["pairs_sharded"] <= 1e-4 and checks["pairs_sharded_2d"] <= 1e-4,
          "sharded per-pair fields differ from card 0 by more than 1e-4")
    check(checks["ensemble_sharded corr_sum rel"] <= 1e-5 and checks["ensemble_sharded count"] == 0,
          "sharded ensemble sums differ from card 0 by more than 1e-5 relative")
    check(checks["get_piv 4 vs 1 device (m/s)"] <= 1e-4 * cc.resolution * FPS,
          "get_piv on four cards differs from one card by more than 1e-4 px")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true", help="only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    import pyorc_tpu  # noqa: F401  (places the compile cache before any compile)

    dev = require_gpu()
    card = card_info()
    say(f"device: {dev.platform} {dev.device_kind}, {len(jax.devices())} device(s), jax {jax.__version__}")
    say(f"card: {card}")
    say(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile cache={jax.config.jax_compilation_cache_dir!r}")
    if args.four:
        four_phase()
    else:
        timings = {}
        proj, cc, v_world = station_phase(timings)
        say(f"peak device memory after station: {peak_bytes()} B ({card})")
        survey_phase(timings)
        say(f"peak device memory after survey: {peak_bytes()} B ({card})")
        t0 = time.perf_counter()
        compare_reference()
        timings["reference"] = (time.perf_counter() - t0, float("nan"))
        multipass_check(proj, cc, v_world, timings)
        say(f"peak device memory after reference: {peak_bytes()} B ({card})")
        table, n_pairs = rates()
        for k, (cold, warm) in timings.items():
            say(f"timing {k}: cold {cold:.3f} s, warm {warm:.3f} s ({card})")
        for (kind, ws, m), (cold, med, best) in sorted(table.items()):
            say(f"rate {kind} {ws}px {m}: {n_pairs / med:.1f} pairs/s median, {n_pairs / best:.1f} best, "
                f"cold {cold:.3f} s ({card})")
        say(f"peak device memory: {peak_bytes()} B ({card})")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))


if __name__ == "__main__":
    sys.exit(main())
