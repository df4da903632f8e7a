"""Streaming PIV over a frame stack: chunked host->device pipeline.

Replaces the reference's memory-chunked ffpiv loop (reference
``pyorc/velocimetry/ffpiv.py:24-474``): frames stream through the device in
HBM-sized chunks (decode prefetch overlaps compute via LazyFrames), each chunk
runs the fused XLA correlation pipeline (:mod:`pyorc_tpu.ops.piv`), and the
ensemble path carries running corr-sum/count accumulators. When more than one
device is visible, chunks are sharded over the pair axis
(:mod:`pyorc_tpu.parallel`).

Deviation from the reference, documented: the reference's ensemble count_min
filter compares pair counts against ``count_min * n_chunks`` (a
chunking-dependent quantity, see reference ffpiv.py:280 where ``n_frames =
len(corr_chunks)``); we use ``count_min * n_pairs`` per the parameter's
documented meaning ("minimum amount of frame pairs").
"""

from __future__ import annotations

import logging
import warnings
from typing import Optional, Tuple

import numpy as np

from .. import ndx
from ..ops import piv as piv_ops
from ..ops import windows as win

__all__ = ["get_piv"]

logger = logging.getLogger(__name__)


def _chunk_plan(n_frames, dim_size, window_size, overlap, search_area_size, chunksize, memory_factor):
    """Frames per chunk from the device-memory model. Reference ffpiv.py:118-139."""
    if chunksize is None:
        req = win.required_memory(n_frames, dim_size, window_size, overlap, search_area_size)
        avail = win.available_memory() / memory_factor
        chunks = int(req // avail) + 1
        chunksize = int(np.ceil(n_frames / chunks))
        if chunksize <= 5:
            warnings.warn(
                f"Memory availability is poor; chunk size automatically set to 5 (was {chunksize}).",
                stacklevel=2,
            )
            chunksize = 5
    if chunksize < 2:
        raise OverflowError("Chunk size must be at least 2 frames.")
    return int(chunksize)


def _shard_enabled() -> bool:
    """Shard chunks over the pair axis when more than one device is visible.

    PYORC_TPU_SHARD=0 forces the single-device path.
    """
    import os

    import jax

    if os.environ.get("PYORC_TPU_SHARD", "1") == "0":
        return False
    return jax.device_count() > 1


def _plan_mesh2d(n_pairs: int, n_rows: int, n_dev: int):
    """Pick a (pairs, rows) mesh split, or None for the 1-D pairs mesh.

    The pair axis is the natural shard dimension; only when a chunk has too
    few pairs to occupy every device does the window-grid row axis take the
    remainder (SURVEY §2.4 bullet 2 — large rasters, short pair batches).
    Returns (dp, dr) with dp*dr == n_dev and dr > 1, or None.
    ``PYORC_TPU_MESH2D`` overrides: "0" disables, an integer forces dr.
    """
    import os

    forced = os.environ.get("PYORC_TPU_MESH2D")
    if forced:
        try:
            dr = int(forced)
        except ValueError:
            dr = None  # non-integer values keep auto behavior
        if dr is not None:
            if dr > 1 and n_dev % dr == 0:
                return (n_dev // dr, dr)
            return None
    if n_pairs >= n_dev:
        return None
    # largest divisor of n_dev that the pair count can still fill
    dp = max(d for d in range(1, n_dev + 1) if n_dev % d == 0 and d <= max(n_pairs, 1))
    dr = n_dev // dp
    if dr <= 1 or n_rows < dr:
        return None
    return (dp, dr)


def _as_device(chunk):
    """Chunk -> device array without a host round-trip.

    Lazy op chains (decode -> filters -> ortho) hand DEVICE arrays to the
    engine; ``np.asarray`` on those would download the whole chunk through
    the host and re-upload it. Only genuinely host-side chunks get a
    device_put.
    """
    import jax

    if isinstance(chunk, jax.Array):
        return chunk
    return jax.device_put(np.asarray(chunk))


def _as_host(chunk):
    """Chunk -> host ndarray (for the host-side mesh sharding paths)."""
    return np.asarray(chunk)


def _run_chunk_oom_backoff(fn, chunk, min_frames=3):
    """Run fn(chunk_frames) with halving splits on device OOM.

    Mirrors the reference's shrinking-chunk retry (reference ffpiv.py:13-21)
    at the device level: a RESOURCE_EXHAUSTED from XLA retries the chunk as
    two halves sharing a one-frame overlap, recursively, and re-concatenates
    the per-pair outputs.
    """
    try:
        return fn(chunk)
    except Exception as e:  # jaxlib raises XlaRuntimeError; match on message
        msg = str(e)
        if "RESOURCE_EXHAUSTED" not in msg and "Out of memory" not in msg.lower():
            raise
        if chunk.shape[0] <= min_frames:
            raise
        warnings.warn(
            f"Device OOM on a {chunk.shape[0]}-frame chunk; retrying as two halves.",
            stacklevel=2,
        )
        mid = chunk.shape[0] // 2
        left = _run_chunk_oom_backoff(fn, chunk[: mid + 1], min_frames)
        right = _run_chunk_oom_backoff(fn, chunk[mid:], min_frames)
        return tuple(np.concatenate([np.asarray(a), np.asarray(b)], axis=0) for a, b in zip(left, right))


def _iter_chunks(data, chunksize):
    """Yield (start_pair_index, frames ndarray) with one-frame overlap between chunks."""
    from ..api.video import LazyFrames

    n = data.shape[0]
    if isinstance(data, LazyFrames):
        for start, batch in data.iter_batches(chunksize, overlap=1):
            if batch.shape[0] >= 2:
                yield start, batch
    else:
        arr = np.asarray(data)
        start = 0
        while start < n - 1:
            end = min(start + chunksize, n)
            yield start, arr[start:end]
            if end >= n:
                break
            start = end - 1


def get_piv(
    frames: ndx.DataArray,
    y: np.ndarray,
    x: np.ndarray,
    dt: ndx.DataArray,
    window_size: Tuple[int, int],
    overlap: Tuple[int, int],
    search_area_size: Tuple[int, int],
    res_y: float,
    res_x: float,
    chunksize: Optional[int] = None,
    memory_factor: float = 4,
    engine: str = "jax",
    ensemble_corr: bool = False,
    corr_min: float = 0.2,
    s2n_min: float = 3.0,
    count_min: float = 0.2,
    signal_threshold: Optional[float] = None,
    passes: int = 1,
) -> ndx.Dataset:
    """Time-resolved or ensemble PIV over the frame stack -> Dataset(v_x, v_y, corr, s2n).

    ``passes > 1`` enables multi-pass adaptive PIV with symmetric window
    deformation (:mod:`pyorc_tpu.ops.multipass`) — an accuracy extension
    beyond the reference's single-pass engine; incompatible with
    ``ensemble_corr`` (deformation is per-pair, averaging planes across
    differently-deformed pairs is ill-defined).
    """
    import jax

    dim_size = tuple(frames.shape[-2:])
    n_frames = frames.shape[0]
    sas = tuple(win._as2(search_area_size))
    ov = tuple(win._as2(overlap))
    n_rows, n_cols = len(y), len(x)
    auto_chunk = chunksize is None
    chunksize = _chunk_plan(n_frames, dim_size, window_size, ov, sas, chunksize, memory_factor)
    if auto_chunk and _shard_enabled():
        # the memory model is per device; sharded chunks split over the mesh,
        # so scale the chunk so each device gets a worthwhile pair batch
        chunksize = min(n_frames, chunksize * jax.device_count())

    time_all = frames["time"].values
    data = frames.data

    with _maybe_profile():
        if ensemble_corr:
            if passes > 1:
                raise ValueError("ensemble_corr=True cannot be combined with passes > 1.")
            return _piv_ensemble(
                data, time_all, y, x, dt, res_y, res_x, n_rows, n_cols, dim_size, sas, ov,
                chunksize, corr_min, s2n_min, count_min, signal_threshold, frames.attrs,
            )
        return _piv_timestep(
            data, time_all, y, x, dt, res_y, res_x, n_rows, n_cols, dim_size, sas, ov,
            chunksize, signal_threshold, frames.attrs, passes,
        )


def _maybe_profile():
    """jax.profiler trace around the PIV loop when PYORC_TPU_PROFILE=<dir>.

    SURVEY §5: the reference has no profiling beyond tqdm; this build
    exposes the XLA profiler (view the trace with TensorBoard or Perfetto).
    """
    import contextlib
    import os

    trace_dir = os.environ.get("PYORC_TPU_PROFILE")
    if not trace_dir:
        return contextlib.nullcontext()
    import jax

    return jax.profiler.trace(trace_dir)


def _piv_timestep(
    data, time_all, y, x, dt, res_y, res_x, n_rows, n_cols, dim_size, sas, ov,
    chunksize, signal_threshold, attrs, passes=1,
):
    import jax

    from ..ops import multipass

    corr_method = piv_ops.corr_route()
    dt_vals = np.asarray(dt.values if hasattr(dt, "values") else dt, dtype=np.float64)
    us, vs, cms, s2ns = [], [], [], []
    n_pairs_total = data.shape[0] - 1
    use_sharded = _shard_enabled()

    def run_one(frames_np):
        if use_sharded:
            from .. import parallel

            if passes > 1:
                return parallel.piv_multipass_sharded(
                    _as_host(frames_np), sas, ov, sas, passes=passes,
                    signal_threshold=signal_threshold, corr_method=corr_method,
                )
            host = _as_host(frames_np)
            plan = _plan_mesh2d(host.shape[0] - 1, n_rows, jax.device_count())
            if plan is not None:
                from jax.sharding import Mesh

                dp, dr = plan
                mesh2d = Mesh(np.asarray(jax.devices()).reshape(dp, dr), ("pairs", "rows"))
                try:
                    return parallel.piv_pairs_sharded_2d(
                        host, sas, ov, sas, mesh=mesh2d, signal_threshold=signal_threshold,
                        corr_method=corr_method,
                    )
                except ValueError:
                    pass  # non-uniform window grid: fall through to the 1-D mesh
            return parallel.piv_pairs_sharded(
                host, sas, ov, sas, signal_threshold=signal_threshold, corr_method=corr_method
            )
        dev = _as_device(frames_np)
        if passes > 1:
            return multipass.piv_multipass(
                dev, dim_size, sas, ov, n_rows, n_cols, passes=passes,
                signal_threshold=signal_threshold, corr_method=corr_method,
            )
        # strip-wise dispatch caps the materialized correlation tensor, which
        # lets small-window configs (geul 16 px at 1080p) run on the CPU
        # backend instead of compile-OOMing in one giant program
        return piv_ops.piv_pairs_strips(
            dev, dim_size, sas, ov, n_rows, n_cols, signal_threshold, corr_method
        )

    done = 0
    for start, chunk in _iter_chunks(data, chunksize):
        u, v, cmax, s2n = _run_chunk_oom_backoff(run_one, chunk)
        us.append(np.asarray(u))
        vs.append(np.asarray(v))
        cms.append(np.asarray(cmax))
        s2ns.append(np.asarray(s2n))
        done += chunk.shape[0] - 1
        logger.info("PIV (per frame pair): %d/%d pairs", done, n_pairs_total)
    u = np.concatenate(us, axis=0)
    v = np.concatenate(vs, axis=0)
    cmax = np.concatenate(cms, axis=0)
    s2n = np.concatenate(s2ns, axis=0)
    time = time_all[1:]
    u = (u * res_x / dt_vals[:, None, None]).astype(np.float32)
    v = (v * res_y / dt_vals[:, None, None]).astype(np.float32)
    return _assemble_ds(s2n, cmax, u, v, time, y, x, attrs)


def _piv_ensemble(
    data, time_all, y, x, dt, res_y, res_x, n_rows, n_cols, dim_size, sas, ov,
    chunksize, corr_min, s2n_min, count_min, signal_threshold, attrs,
):
    corr_method = piv_ops.corr_route()
    corr_sum = 0.0
    corr_count = 0.0
    cms, s2ns = [], []
    n_pairs_total = data.shape[0] - 1
    use_sharded = _shard_enabled()
    done = 0
    for start, chunk in _iter_chunks(data, chunksize):
        if use_sharded:
            from .. import parallel

            cs, cc, cmax, s2n = parallel.piv_ensemble_sharded(
                _as_host(chunk), sas, ov, sas,
                corr_min=corr_min, s2n_min=s2n_min, signal_threshold=signal_threshold,
                corr_method=corr_method,
            )
        else:
            cs, cc, cmax, s2n = piv_ops.piv_ensemble_scan(
                _as_device(chunk), dim_size, sas, ov, n_rows, n_cols,
                corr_min, s2n_min, signal_threshold, corr_method,
            )
        corr_sum = corr_sum + np.asarray(cs)
        corr_count = corr_count + np.asarray(cc)
        cms.append(np.asarray(cmax))
        s2ns.append(np.asarray(s2n))
        done += chunk.shape[0] - 1
        logger.info("PIV (ensemble): %d/%d pairs", done, n_pairs_total)
    cmax_all = np.concatenate(cms, axis=0)
    s2n_all = np.concatenate(s2ns, axis=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        low_count = corr_count < count_min * n_pairs_total
        corr_sum[low_count] = np.nan
        flat_low = low_count.reshape(n_rows, n_cols)
        cmax_all = np.where(flat_low[None], np.nan, cmax_all)
        corr_mean = corr_sum / np.maximum(corr_count, 1)[..., None, None]
        corr_mean[corr_count == 0] = np.nan
        # zeroed (rejected) planes must not drag the time stats down
        cmax_masked = np.where(cmax_all == 0.0, np.nan, cmax_all)
        s2n_masked = np.where(s2n_all == 0.0, np.nan, s2n_all)
        cmax_mean = np.nanmean(cmax_masked, axis=0).reshape(1, n_rows, n_cols)
        s2n_mean = np.nanmean(s2n_masked, axis=0).reshape(1, n_rows, n_cols)
    u, v = piv_ops.u_v_displacement(np.asarray(corr_mean)[None], n_rows, n_cols)
    u = np.asarray(u)
    v = np.asarray(v)
    dt_av = float(np.asarray(dt.values if hasattr(dt, "values") else dt).mean())
    u = (u * res_x / dt_av).astype(np.float32)
    v = (v * res_y / dt_av).astype(np.float32)
    # NaN out low-count cells in displacements too
    u[0][flat_low] = np.nan
    v[0][flat_low] = np.nan
    time = time_all[1:2]
    return _assemble_ds(s2n_mean, cmax_mean, u, v, time, y, x, attrs)


def _assemble_ds(s2n, corr, u, v, time, y, x, attrs) -> ndx.Dataset:
    from .. import const

    ds = ndx.Dataset(
        {
            "s2n": (("time", "y", "x"), s2n.astype(np.float32), const.VARS_ATTRS["s2n"]),
            "corr": (("time", "y", "x"), corr.astype(np.float32), const.VARS_ATTRS["corr"]),
            "v_x": (("time", "y", "x"), u, const.VARS_ATTRS["v_x"]),
            "v_y": (("time", "y", "x"), v, const.VARS_ATTRS["v_y"]),
        },
        coords={"time": np.asarray(time), "y": np.asarray(y), "x": np.asarray(x)},
        attrs=dict(attrs),
    )
    return ds
