"""Orthorectification: per-frame projective remap as a static-gather XLA kernel.

Replaces the reference's per-frame numpy scatter + numba group-mean
(reference ``pyorc/project.py:19-53,123-161``): the index maps (world grid <->
image pixels, computed once per video/water level by
``CameraConfig.map_idx_img_ortho`` / ``map_mean_idx_img_ortho``) become static
gather/segment-sum indices, so the whole batch of frames is remapped in one
fused device op — no data-dependent control flow, no host round-trips.

Layout: everything is ONE gather from a padded source
``[frame pixels | zero sentinel | group means]`` indexed by a single
precomputed ``full_idx`` per target cell. Compared to the earlier
gather+mask+scatter formulation this (a) keeps the gather in the SOURCE
dtype (uint8 frames move 4x fewer bytes than float32), (b) needs no
covered-mask multiply (uncovered cells point at the sentinel), and (c)
needs no scatter for the oversampled-cell means (mean cells point into
the appended means block). Group means are computed in float32 and cast to
the source dtype — for uint8 frames that truncation happened anyway in the
callers' final ``astype``; results are bit-identical.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "OrthoMaps",
    "build_ortho_maps",
    "project_batch",
    "source_bbox",
    "crop_maps",
]


class OrthoMaps(NamedTuple):
    """Static index maps for one (camera_config, water level) pair."""

    full_idx: np.ndarray  # [rows*cols] indices into [src (H*W) | zero | means]
    src_idx: Optional[np.ndarray]  # [n_mean] flat source indices for group-mean
    norm_idx: Optional[np.ndarray]  # [n_mean] group id per src sample
    counts: Optional[np.ndarray]  # [n_groups] static group sizes
    shape_in: Tuple[int, int]  # (H, W) of camera frames
    shape_out: Tuple[int, int]  # (rows, cols) of ortho grid
    # separable fast path (axis-aligned maps: near-nadir footage on a grid
    # aligned with the sensor): row index depends only on the output row and
    # column index only on the output column, every cell covered, no mean
    # groups. The remap then factors into two large-slice gathers (or pure
    # strided slices) instead of one element gather per output pixel.
    row_idx: Optional[np.ndarray] = None  # [rows] source row per output row
    col_idx: Optional[np.ndarray] = None  # [cols] source col per output col


def build_ortho_maps(camera_config, x, y, z, reducer: str = "mean") -> OrthoMaps:
    """Precompute index maps on the host (once per video / water level)."""
    idx_img, idx_ortho = camera_config.map_idx_img_ortho(x, y, z)
    ortho_pos = np.where(idx_ortho)[0]
    h, w = camera_config.height, camera_config.width
    n_src = h * w
    # uncovered cells point at the zero sentinel appended after the frame
    full_idx = np.full(len(x) * len(y), n_src, np.int32)
    full_idx[np.asarray(ortho_pos)] = np.asarray(idx_img)
    if reducer == "mean":
        src_idx, uidx, norm_idx = camera_config.map_mean_idx_img_ortho(x, y, z)
    else:
        src_idx = uidx = norm_idx = None
    counts = None
    if src_idx is not None and len(np.asarray(uidx)):
        src_idx = np.asarray(src_idx, dtype=np.int32)
        norm_idx = np.asarray(norm_idx, dtype=np.int32)
        uidx = np.asarray(uidx, dtype=np.int64)
        counts = np.bincount(norm_idx, minlength=len(uidx)).astype(np.float32)
        # oversampled cells read their group's mean from the appended block
        full_idx[uidx] = n_src + 1 + np.arange(len(uidx), dtype=np.int64)
    else:
        src_idx = norm_idx = None
    ny, nx = len(y), len(x)
    row_idx = col_idx = None
    if src_idx is None and (full_idx != n_src).all():
        fi2 = full_idx.reshape(ny, nx)
        rr = fi2 // w
        cc = fi2 % w
        if (rr == rr[:, :1]).all() and (cc == cc[:1, :]).all():
            row_idx = np.ascontiguousarray(rr[:, 0], dtype=np.int32)
            col_idx = np.ascontiguousarray(cc[0, :], dtype=np.int32)
    return OrthoMaps(
        full_idx=full_idx,
        src_idx=src_idx,
        norm_idx=norm_idx,
        counts=counts,
        shape_in=(h, w),
        shape_out=(ny, nx),
        row_idx=row_idx,
        col_idx=col_idx,
    )


def source_bbox(maps: OrthoMaps) -> Optional[Tuple[int, int, int, int]]:
    """Source-pixel bounding box ``(r0, r1, c0, c1)`` (half-open) actually
    read by the maps, or None when the maps read nothing.

    The ortho grid typically consumes a sub-rectangle of the camera frame
    (the AOI bbox re-projected into pixel space); everything outside it never
    influences the output, so callers can crop frames to this box *before*
    the host->device upload (see ``crop_maps``) and move proportionally fewer
    bytes per chunk.
    """
    h, w = maps.shape_in
    if maps.row_idx is not None:
        r0, r1 = int(maps.row_idx.min()), int(maps.row_idx.max()) + 1
        c0, c1 = int(maps.col_idx.min()), int(maps.col_idx.max()) + 1
        return (r0, r1, c0, c1)
    n_src = h * w
    used = maps.full_idx[maps.full_idx < n_src]
    if maps.src_idx is not None:
        used = np.concatenate([used, maps.src_idx])
    if len(used) == 0:
        return None
    rows = used // w
    cols = used % w
    return (int(rows.min()), int(rows.max()) + 1, int(cols.min()), int(cols.max()) + 1)


def crop_maps(maps: OrthoMaps, r0: int, c0: int, hc: int, wc: int) -> OrthoMaps:
    """Rebase the maps onto frames pre-cropped to ``[r0:r0+hc, c0:c0+wc]``.

    Every source index must fall inside the crop (use ``source_bbox`` to
    compute a covering box); results are bit-identical to projecting the
    uncropped frames with the original maps.
    """
    h, w = maps.shape_in
    n_src = h * w
    n_crop = hc * wc
    if maps.row_idx is not None:
        row_idx = (maps.row_idx - r0).astype(np.int32)
        col_idx = (maps.col_idx - c0).astype(np.int32)
        assert row_idx.min() >= 0 and row_idx.max() < hc
        assert col_idx.min() >= 0 and col_idx.max() < wc
        fi2 = row_idx[:, None].astype(np.int64) * wc + col_idx[None, :]
        return maps._replace(
            full_idx=fi2.reshape(-1).astype(np.int32),
            shape_in=(hc, wc),
            row_idx=row_idx,
            col_idx=col_idx,
        )

    def rebase(idx):
        idx = np.asarray(idx, dtype=np.int64)
        rr = idx // w - r0
        cc = idx % w - c0
        if idx.size:
            assert rr.min() >= 0 and rr.max() < hc and cc.min() >= 0 and cc.max() < wc
        return rr * wc + cc

    full_idx = np.asarray(maps.full_idx, dtype=np.int64)
    src = full_idx < n_src
    out = np.empty_like(full_idx)
    out[src] = rebase(full_idx[src])
    # sentinel and mean-block entries shift with the new source size
    out[~src] = full_idx[~src] - n_src + n_crop
    src_idx = None if maps.src_idx is None else rebase(maps.src_idx).astype(np.int32)
    return maps._replace(
        full_idx=out.astype(np.int32), src_idx=src_idx, shape_in=(hc, wc)
    )


@functools.partial(jax.jit, static_argnums=(2, 3))
def _project_batch_jit(flat_frames, maps_arrays, n_groups, shape_out):
    full_idx, src_idx, norm_idx, counts = maps_arrays
    ny, nx = shape_out
    t = flat_frames.shape[0]
    zero = jnp.zeros((t, 1), flat_frames.dtype)
    if src_idx is not None:
        samples = jnp.take(flat_frames, src_idx, axis=1).astype(jnp.float32)
        sums = jax.ops.segment_sum(samples.T, norm_idx, num_segments=n_groups).T
        means = (sums / counts[None, :]).astype(flat_frames.dtype)
        padded = jnp.concatenate([flat_frames, zero, means], axis=1)
    else:
        padded = jnp.concatenate([flat_frames, zero], axis=1)
    out = jnp.take(padded, full_idx, axis=1)
    return out.reshape(t, ny, nx)


# device-resident copies of the index maps, keyed by the identity of the
# host arrays: the PIV chain calls project_batch once per streamed chunk, and
# re-uploading ~20 MB of int32 maps per chunk costs more than the gather
# itself. Keys hold a reference to
# the host array so ids stay valid for the cache's lifetime.
_DEVICE_MAPS_CACHE = {}


def _device_maps(maps: OrthoMaps):
    key = id(maps.full_idx)
    hit = _DEVICE_MAPS_CACHE.get(key)
    if hit is not None and hit[0] is maps.full_idx:
        return hit[1]
    arrays = (
        jnp.asarray(maps.full_idx),
        None if maps.src_idx is None else jnp.asarray(maps.src_idx),
        None if maps.norm_idx is None else jnp.asarray(maps.norm_idx),
        None if maps.counts is None else jnp.asarray(maps.counts),
        None if maps.row_idx is None else jnp.asarray(maps.row_idx),
        None if maps.col_idx is None else jnp.asarray(maps.col_idx),
    )
    if len(_DEVICE_MAPS_CACHE) >= 8:
        _DEVICE_MAPS_CACHE.pop(next(iter(_DEVICE_MAPS_CACHE)))
    _DEVICE_MAPS_CACHE[key] = (maps.full_idx, arrays)
    return arrays


def _arith_spec(idx: np.ndarray):
    """(start, limit, step) when ``idx`` is an arithmetic ramp, else None."""
    if len(idx) == 0:
        return None
    if len(idx) == 1:
        return (int(idx[0]), int(idx[0]) + 1, 1)
    step = int(idx[1]) - int(idx[0])
    if step > 0 and (np.diff(idx) == step).all():
        start = int(idx[0])
        return (start, start + step * (len(idx) - 1) + 1, step)
    return None


@functools.partial(jax.jit, static_argnums=(1, 2))
def _sep_slice_jit(frames, rspec, cspec):
    out = jax.lax.slice_in_dim(frames, rspec[0], rspec[1], stride=rspec[2], axis=1)
    return jax.lax.slice_in_dim(out, cspec[0], cspec[1], stride=cspec[2], axis=2)


@jax.jit
def _sep_take_jit(frames, row_idx, col_idx):
    return jnp.take(jnp.take(frames, row_idx, axis=1), col_idx, axis=2)


def project_batch(frames, maps: OrthoMaps):
    """Orthorectify a batch of frames [T, H, W] -> [T, rows, cols].

    Output dtype equals the input dtype (uint8 stays uint8 end to end);
    uncovered target cells are zero. Separable maps take the two-slice /
    two-gather fast path (bit-identical; ~7x on 4K frames).
    """
    frames = jnp.asarray(frames)
    if frames.dtype not in (jnp.uint8.dtype, jnp.float32.dtype):
        frames = frames.astype(jnp.float32)
    if maps.row_idx is not None:
        rspec = _arith_spec(maps.row_idx)
        cspec = _arith_spec(maps.col_idx)
        if rspec is not None and cspec is not None:
            return _sep_slice_jit(frames, rspec, cspec)
        dmaps = _device_maps(maps)
        return _sep_take_jit(frames, dmaps[4], dmaps[5])
    flat = frames.reshape(frames.shape[0], -1)
    n_groups = 0 if maps.counts is None else int(len(maps.counts))
    return _project_batch_jit(flat, _device_maps(maps)[:4], n_groups, maps.shape_out)
