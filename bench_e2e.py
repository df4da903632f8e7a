"""End-to-end benchmark: decode -> orthorectify -> ensemble PIV -> discharge.

Measures the BASELINE.md headline workload — a 1-minute 4K@30fps river video
through the full pipeline — on one GPU, with the decode/compute overlap
reported (the lazy frame chain runs decode + filters + orthorectification in
the prefetch thread while PIV occupies the device). Host decode scales with
the host's cores (``host_cores`` is reported); the device-bound PIV rate is
measured separately by bench.py with on-device data.

The clip is synthesized once (particle texture advected at a known speed,
H.264 via the native libx264 writer, so the native decoder must build) and
cached in the temporary directory. Run with ``--seconds 10`` for a quick
pass; default is the full 60 s workload. Exits non-zero when JAX finds no GPU.

Prints ONE JSON line, tagged with the device and the card's power limit.
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np

W_IMG, H_IMG = 3840, 2160
FPS = 30.0
RES = 0.01  # m/px at the water plane
DX_PIX, DY_PIX = 1.8, -0.9  # px/frame advection -> |v| ~ 0.6 m/s


def synth_clip(path: str, n_frames: int) -> float:
    """Render + H.264-encode the advecting particle clip; returns seconds."""
    from scipy.ndimage import gaussian_filter

    from pyorc_tpu.io.native_decoder import NativeVideoWriter

    rng = np.random.default_rng(11)
    pad_x = int(abs(DX_PIX) * n_frames + 2)
    pad_y = int(abs(DY_PIX) * n_frames + 2)
    big_h, big_w = H_IMG + pad_y, W_IMG + pad_x
    n_particles = int(big_h * big_w * 0.006)
    img = np.zeros((big_h, big_w), np.float32)
    xs = rng.uniform(0, big_w - 1, n_particles)
    ys = rng.uniform(0, big_h - 1, n_particles)
    np.add.at(img, (ys.astype(int), xs.astype(int)), rng.uniform(0.5, 1.0, n_particles))
    img = gaussian_filter(img, 1.2)
    img = np.clip(img / img.max() * 235 + 15, 0, 255)

    t0 = time.perf_counter()
    with NativeVideoWriter(path, W_IMG, H_IMG, fps=FPS, channels=1, crf=20) as wr:
        for i in range(n_frames):
            # slide a window over the big texture with bilinear subpixel
            ox = DX_PIX * i if DX_PIX >= 0 else pad_x - 1 + DX_PIX * i
            oy = DY_PIX * i if DY_PIX >= 0 else pad_y - 1 + DY_PIX * i
            ix, iy = int(ox), int(oy)
            fx, fy = ox - ix, oy - iy
            w00 = (1 - fy) * (1 - fx)
            w01 = (1 - fy) * fx
            w10 = fy * (1 - fx)
            w11 = fy * fx
            sl = img[iy : iy + H_IMG + 1, ix : ix + W_IMG + 1]
            frame = (
                w00 * sl[:-1, :-1] + w01 * sl[:-1, 1:] + w10 * sl[1:, :-1] + w11 * sl[1:, 1:]
            )
            wr.write(frame.astype(np.uint8))
    return time.perf_counter() - t0


def nadir_config(height: int = H_IMG, width: int = W_IMG):
    """Nadir camera at RES m/px: GCPs 200 px and the AOI 300 px inside the frame."""
    import pyorc_tpu

    f = 6000.0 * width / W_IMG
    src = [[200, 200], [width - 200, 200], [width - 200, height - 200], [200, height - 200]]
    dst = [[RES * c, RES * (height - r)] for c, r in src]
    cc = pyorc_tpu.CameraConfig(
        height=height,
        width=width,
        resolution=RES,
        window_size=64,
        gcps={"src": src, "dst": dst, "h_ref": 0.0, "z_0": 0.0},
        camera_matrix=[[f, 0.0, width / 2], [0.0, f, height / 2], [0.0, 0.0, 1.0]],
        dist_coeffs=[[0.0]] * 5,
        stabilize=None,
    )
    m = 300
    cc.set_bbox_from_corners([[m, m], [width - m, m], [width - m, height - m], [m, height - m]])
    return cc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--no-cache", action="store_true")
    args = ap.parse_args()

    import pyorc_tpu
    from bench import device_tags

    tags = device_tags()
    n_frames = int(args.seconds * FPS)
    clip = os.path.join(tempfile.gettempdir(), f"pyorc_tpu_e2e_{int(args.seconds)}s_4k.mp4")
    t_render = 0.0
    if args.no_cache or not os.path.isfile(clip):
        # write-then-rename so an interrupted render never leaves a truncated
        # clip behind for the cache check
        tmp = clip + ".tmp.mp4"
        t_render = synth_clip(tmp, n_frames)
        os.replace(tmp, clip)

    cc = nadir_config()
    cc.window_size = args.window

    stages = {}
    t0 = time.perf_counter()
    video = pyorc_tpu.Video(clip, camera_config=cc, start_frame=0, end_frame=n_frames - 1, h_a=0.0)
    stages["video_open"] = time.perf_counter() - t0

    # decode-only throughput on a probe slice (for the overlap accounting).
    # The probe's wall time is reported separately and NOT counted in the
    # pipeline total: it is measurement overhead (the lazy chain re-decodes
    # these frames as part of its own timed stage).
    t0 = time.perf_counter()
    probe_n = min(64, n_frames)
    _ = np.asarray(video.get_frames().data[:probe_n])
    probe_s = time.perf_counter() - t0
    decode_fps = probe_n / probe_s

    t0 = time.perf_counter()
    da = video.get_frames()
    da = da.frames.normalize(samples=8)
    proj = da.frames.project()
    stages["lazy_chain_setup"] = time.perf_counter() - t0  # incl. sampled-mean decode

    # per-frame upload footprint after the host-side bbox crop (probe the
    # chain's first op; it returns (cropped, stats) when the crop engaged)
    probe = proj.data._ops[0](np.zeros((1, H_IMG, W_IMG), np.uint8))
    upl_shape = (probe[0] if isinstance(probe, tuple) else probe).shape[1:]
    upload_gb = n_frames * int(np.prod(upl_shape)) / 1e9

    t0 = time.perf_counter()
    piv = proj.frames.get_piv(window_size=args.window, ensemble_corr=True)
    stages["decode_ortho_piv"] = time.perf_counter() - t0

    # discharge over a synthetic parabolic cross-section spanning the bbox
    t0 = time.perf_counter()
    coords = np.asarray(cc.bbox.exterior.coords)
    p_left = (coords[0] + coords[1]) / 2
    p_right = (coords[2] + coords[3]) / 2
    n = 31
    xs = np.linspace(p_left[0], p_right[0], n)
    ys = np.linspace(p_left[1], p_right[1], n)
    t = np.linspace(-1, 1, n)
    zs = -0.05 - 0.4 * (1 - t**2)
    tr = piv.velocimetry.get_transect(xs, ys, zs, wdw=1)
    tr = tr.transect.get_q(fill_method="interpolate")
    tr.transect.get_river_flow()
    q_med = float(np.nanmedian(tr["river_flow"].values))
    stages["transect_discharge"] = time.perf_counter() - t0

    total = sum(stages.values())
    n_pairs = n_frames - 1
    pairs_per_sec = n_pairs / stages["decode_ortho_piv"]

    print(
        json.dumps(
            {
                "metric": f"e2e_4k_{int(args.seconds)}s_single_chip_seconds",
                "value": round(total, 2),
                "unit": "s",
                **tags,
                "stages_s": {k: round(v, 2) for k, v in stages.items()},
                "decode_fps": round(decode_fps, 1),
                "probe_decode_s_excluded": round(probe_s, 2),
                "pairs_per_sec_e2e": round(pairs_per_sec, 1),
                "river_flow_m3s_median": round(q_med, 3),
                "clip_render_s": round(t_render, 1),
                "n_frames": n_frames,
                "host_cores": os.cpu_count(),
                "upload_gb": round(upload_gb, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
