"""Benchmark: PIV frame pairs per second on one GPU, 1080p frames, 64 px windows.

Prints ONE JSON line: {"metric", "value", "unit"} with the device it ran on
(``platform``, ``device_kind``, ``device_count``) and the card's name and
power limit from nvidia-smi. Exits non-zero when JAX finds no GPU: a number
from another backend is never written under this metric.

Options:
    --full         per-pair and ensemble rates at 16/26/32/64 px
    --chain        the 4K normalize -> orthorectify -> ensemble PIV chain
    --trace DIR    one per-pair step at 26 px under jax.profiler, written to
                   DIR, and the share of device time in window extraction,
                   correlation and peak fitting

Frames are made on the device, so the rates are device-bound PIV without
host decode or upload. Each rate is the median of several runs, each ending
in ``block_until_ready``; the first (compiling) call is not timed.
"""

import glob
import json
import subprocess
import sys
import time

import numpy as np


def require_gpu():
    """The first JAX device; exits with status 1 unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU, JAX found {dev.platform!r}")
    return dev


def card_info() -> str:
    """The cards' names and power limits, from nvidia-smi (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return "; ".join(line.strip() for line in out.stdout.splitlines() if line.strip())


def device_tags() -> dict:
    import os

    import jax

    dev = require_gpu()
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card_info(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }


def _median_seconds(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _frames(n_frames, h, w, seed=0):
    import jax
    import jax.numpy as jnp

    return jax.random.uniform(jax.random.PRNGKey(seed), (n_frames, h, w), jnp.float32, 0, 255)


def _bench_config(window: int, h: int = 1088, w: int = 1920, n_frames: int = 65, reps: int = 8):
    """Per-pair pairs/s for one window size (correlation method per corr_route)."""
    from pyorc_tpu.ops import piv, windows

    sas = (window, window)
    overlap = (window // 2, window // 2)
    n_rows, n_cols = windows.get_field_shape((h, w), sas, overlap)
    frames = _frames(n_frames, h, w)
    dt = _median_seconds(lambda: piv.piv_pairs(frames, (h, w), sas, overlap, n_rows, n_cols), reps)
    return (n_frames - 1) / dt


def _bench_ensemble(window: int, h: int = 1088, w: int = 1920, n_frames: int = 65, reps: int = 5):
    """Ensemble-accumulation pairs/s at one window size (the reference's
    long-video configuration, pyorc/velocimetry/ffpiv.py:182-376)."""
    from pyorc_tpu.ops import piv, windows

    sas = (window, window)
    overlap = (window // 2, window // 2)
    n_rows, n_cols = windows.get_field_shape((h, w), sas, overlap)
    frames = _frames(n_frames, h, w)
    dt = _median_seconds(
        lambda: piv.piv_ensemble_scan(frames, (h, w), sas, overlap, n_rows, n_cols), reps
    )
    return (n_frames - 1) / dt


def _bench_chain_4k(window: int = 64, n_frames: int = 33, reps: int = 3):
    """4K normalize + orthorectify + ensemble PIV chain, pairs/s.

    Runs the ops the lazy frame chain dispatches per chunk after the upload
    crop (flt.normalize_with_stats on bbox-cropped frames with host-supplied
    extrema -> ortho.project_batch with crop-rebased maps ->
    piv_ensemble_scan) on device-made uint8 frames with the bench_e2e camera
    config's real ortho index maps: the device-bound rate of the workload
    minus decode.
    """
    import jax
    import jax.numpy as jnp

    from bench_e2e import nadir_config
    from pyorc_tpu.ops import filters as flt
    from pyorc_tpu.ops import ortho as ortho_ops
    from pyorc_tpu.ops import piv, windows

    cc = nadir_config()
    shape = cc.shape
    y = np.flipud(np.linspace(cc.resolution / 2, cc.resolution * (shape[0] - 0.5), shape[0]))
    x = np.linspace(cc.resolution / 2, cc.resolution * (shape[1] - 0.5), shape[1])
    maps = ortho_ops.build_ortho_maps(cc, x, y, 0.0, reducer="mean")
    r0, r1, c0, c1 = ortho_ops.source_bbox(maps)
    maps = ortho_ops.crop_maps(maps, r0, c0, r1 - r0, c1 - c0)
    oh, ow = maps.shape_out
    sas = (window, window)
    overlap = (window // 2, window // 2)
    n_rows, n_cols = windows.get_field_shape((oh, ow), sas, overlap)

    key = jax.random.PRNGKey(3)
    frames = jax.random.randint(key, (n_frames, r1 - r0, c1 - c0), 0, 255, jnp.int32).astype(jnp.uint8)
    mean_img = jnp.zeros((r1 - r0, c1 - c0), jnp.float32) + 127.0
    fmin = jnp.full((n_frames, 1, 1), -127.0, jnp.float32)
    fmax = jnp.full((n_frames, 1, 1), 128.0, jnp.float32)

    def chain():
        f = flt.normalize_with_stats(frames, mean_img, fmin, fmax)
        f = ortho_ops.project_batch(f, maps)
        return piv.piv_ensemble_scan(f, (oh, ow), sas, overlap, n_rows, n_cols)

    return (n_frames - 1) / _median_seconds(chain, reps)


# device-time categories of one per-pair step, by the named scopes in
# pyorc_tpu.ops.piv; a fusion that spans scopes counts as "other"
TRACE_SCOPES = ("window_extract", "correlate", "peak")


def trace_shares(xplane_path: str) -> dict:
    """Reduce a profiler trace to device busy time and its shares by scope.

    Busy time is the union of the GPU planes' event intervals; each event is
    attributed to the first of ``TRACE_SCOPES`` found in its ``name`` stat
    (the jax op path), else to "other". Shares are of the summed event time.
    """
    import jax

    data = jax.profiler.ProfileData.from_file(xplane_path)
    sums = dict.fromkeys(TRACE_SCOPES + ("other",), 0.0)
    intervals = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                name = next((str(v) for k, v in ev.stats if k == "name"), "")
                scope = next((s for s in TRACE_SCOPES if s in name), "other")
                sums[scope] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not intervals:
        raise RuntimeError(f"no GPU events in {xplane_path}")
    intervals.sort()
    busy, (lo, hi) = 0.0, intervals[0]
    for a, b in intervals[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    total = sum(sums.values())
    return {
        "busy_ms": busy / 1e6,
        "span_ms": (max(b for _, b in intervals) - intervals[0][0]) / 1e6,
        "shares": {k: v / total for k, v in sums.items()},
    }


def _trace_pairs(trace_dir: str, window: int = 26, h: int = 1088, w: int = 1920, n_frames: int = 65):
    import jax

    from pyorc_tpu.ops import piv, windows

    sas = (window, window)
    overlap = (window // 2, window // 2)
    n_rows, n_cols = windows.get_field_shape((h, w), sas, overlap)
    frames = _frames(n_frames, h, w)
    jax.block_until_ready(piv.piv_pairs(frames, (h, w), sas, overlap, n_rows, n_cols))  # compile
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(piv.piv_pairs(frames, (h, w), sas, overlap, n_rows, n_cols))
    path = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))[-1]
    return {"window": window, "pairs": n_frames - 1, **trace_shares(path)}


def main():
    from pyorc_tpu.ops import piv

    tags = device_tags()
    h, w = 1088, 1920
    out = {
        "metric": "piv_frame_pairs_per_sec_64x64_1080p",
        "value": round(_bench_config(64, h, w), 2),
        "unit": "pairs/s",
        **tags,
        "corr_method": piv.corr_route(),
    }
    if "--full" in sys.argv:
        # the reference's window sizes: ngwerere 25 -> 26 px, geul 15 -> 16 px
        out["per_pair"] = {f"{win}px_1080p": round(_bench_config(win, h, w), 1) for win in (16, 26, 32, 64)}
        out["ensemble"] = {f"{win}px_1080p": round(_bench_ensemble(win, h, w), 1) for win in (16, 26, 32, 64)}
    if "--chain" in sys.argv or "--full" in sys.argv:
        out["chain_4k_pairs_per_sec"] = round(_bench_chain_4k(), 1)
    if "--trace" in sys.argv:
        out["trace"] = _trace_pairs(sys.argv[sys.argv.index("--trace") + 1])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
