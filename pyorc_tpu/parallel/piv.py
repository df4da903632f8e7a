"""Sharded PIV: frame pairs distributed over a 1-D device mesh.

Frame pairs are embarrassingly parallel; consecutive pairs share one frame, so
each device receives its contiguous slice of frames plus a one-frame halo
(built on the host by stacking overlapping slices — cheaper than a device-side
halo exchange for this access pattern). Per-timestep PIV needs no collectives
at all; ensemble PIV reduces its correlation-sum/count accumulators with a
``psum`` over the pair axis.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import piv as piv_ops
from ..ops import windows as win

__all__ = ["make_mesh", "piv_pairs_sharded", "piv_ensemble_sharded", "piv_multipass_sharded", "piv_pairs_sharded_2d", "pad_pairs_for_devices"]


def make_mesh(devices=None, axis: str = "pairs") -> Mesh:
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis,))


def pad_pairs_for_devices(imgs: np.ndarray, n_dev: int) -> Tuple[np.ndarray, int]:
    """Stack frames into per-device overlapping slices [D, P+1, H, W].

    Pads (repeating the last frame) so every device gets the same static
    shape; padded pairs are dropped by the caller using the returned true
    pair count.
    """
    t = imgs.shape[0]
    n_pairs = t - 1
    per_dev = -(-n_pairs // n_dev)  # ceil
    total = per_dev * n_dev
    pad = total - n_pairs
    if pad > 0:
        imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, axis=0)], axis=0)
    slices = [imgs[d * per_dev : d * per_dev + per_dev + 1] for d in range(n_dev)]
    return np.stack(slices), n_pairs


def piv_pairs_sharded(
    imgs: np.ndarray,
    window_size: Tuple[int, int],
    overlap: Tuple[int, int],
    search_area_size: Optional[Tuple[int, int]] = None,
    mesh: Optional[Mesh] = None,
    signal_threshold: Optional[float] = None,
    corr_method: str = "auto",
):
    """Per-timestep PIV sharded over frame pairs.

    Returns (u, v, corr_max, s2n) each [n_pairs, n_rows, n_cols] (numpy).
    """
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    sas = tuple(win._as2(window_size if search_area_size is None else search_area_size))
    ov = tuple(win._as2(overlap))
    dim_size = imgs.shape[-2:]
    n_rows, n_cols = win.get_field_shape(dim_size, sas, ov)
    stacked, n_pairs = pad_pairs_for_devices(np.asarray(imgs), n_dev)
    method = piv_ops.corr_route(corr_method)

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P("pairs"), out_specs=P("pairs"))
    def run(frames_dev):
        # frames_dev: [1, P+1, H, W] on each device; no collectives
        u, v, cmax, s2n = piv_ops.piv_pairs(
            frames_dev[0], dim_size, sas, ov, n_rows, n_cols, signal_threshold, method
        )
        return u[None], v[None], cmax[None], s2n[None]

    sharding = NamedSharding(mesh, P("pairs"))
    stacked_dev = jax.device_put(stacked, sharding)
    u, v, cmax, s2n = jax.jit(run)(stacked_dev)
    out = tuple(np.asarray(a).reshape(-1, n_rows, n_cols)[:n_pairs] for a in (u, v, cmax, s2n))
    return out


def piv_ensemble_sharded(
    imgs: np.ndarray,
    window_size: Tuple[int, int],
    overlap: Tuple[int, int],
    search_area_size: Optional[Tuple[int, int]] = None,
    mesh: Optional[Mesh] = None,
    corr_min: float = 0.2,
    s2n_min: float = 3.0,
    signal_threshold: Optional[float] = None,
    corr_method: str = "auto",
):
    """Ensemble PIV sharded over frame pairs with psum-reduced accumulators.

    Returns (corr_sum [n_windows, wy, wx], corr_count [n_windows],
    corr_max [n_pairs, n_rows, n_cols], s2n [n_pairs, n_rows, n_cols]).
    """
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    sas = tuple(win._as2(window_size if search_area_size is None else search_area_size))
    ov = tuple(win._as2(overlap))
    dim_size = imgs.shape[-2:]
    n_rows, n_cols = win.get_field_shape(dim_size, sas, ov)
    stacked, n_pairs = pad_pairs_for_devices(np.asarray(imgs), n_dev)
    method = piv_ops.corr_route(corr_method)
    per_dev = stacked.shape[1] - 1
    # mask out padded pairs inside the reduction
    pair_valid = (np.arange(n_dev * per_dev) < n_pairs).reshape(n_dev, per_dev)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("pairs"), P("pairs")),
        out_specs=(P(), P(), P("pairs"), P("pairs")),
    )
    def run(frames_dev, valid_dev):
        frames = frames_dev[0]
        valid = valid_dev[0]
        row0, col0 = win.get_window_starts(dim_size, sas, ov)
        w = piv_ops.extract_windows(frames.astype(jnp.float32), row0, col0, sas[0], sas[1])
        n_windows = w.shape[1]
        if signal_threshold is not None:
            signal = jnp.mean(w > 0, axis=(-2, -1))
            sig_ok = jnp.minimum(signal[:-1], signal[1:]) >= signal_threshold
        else:
            sig_ok = jnp.ones((w.shape[0] - 1, n_windows), dtype=bool)
        sig_ok = sig_ok & valid[:, None]

        def step(carry, pair):
            corr_sum, corr_count = carry
            wa, wb, ok_sig = pair
            corr = piv_ops._normalized_corr_planes(wa, wb, method)
            corr = jnp.where(ok_sig[..., None, None], corr, jnp.nan)
            corr_max = jnp.nanmax(corr, axis=(-2, -1))
            s2n = corr_max / jnp.nanmean(corr, axis=(-2, -1))
            ok = (corr_max >= corr_min) & (s2n >= s2n_min) & jnp.isfinite(corr_max)
            corr = jnp.where(ok[..., None, None], corr, 0.0)
            return (
                (corr_sum + jnp.nan_to_num(corr), corr_count + ok.astype(jnp.float32)),
                (jnp.where(ok, corr_max, 0.0), jnp.where(ok, s2n, 0.0)),
            )

        # carry must be marked device-varying for the scan inside shard_map
        init = (
            jax.lax.pcast(jnp.zeros((n_windows, sas[0], sas[1]), dtype=jnp.float32), "pairs", to="varying"),
            jax.lax.pcast(jnp.zeros((n_windows,), dtype=jnp.float32), "pairs", to="varying"),
        )
        (corr_sum, corr_count), (corr_max, s2n) = jax.lax.scan(step, init, (w[:-1], w[1:], sig_ok))
        # the only collective in the pipeline: all-reduce the ensemble accumulators
        corr_sum = jax.lax.psum(corr_sum, "pairs")
        corr_count = jax.lax.psum(corr_count, "pairs")
        return corr_sum, corr_count, corr_max[None], s2n[None]

    sharding = NamedSharding(mesh, P("pairs"))
    stacked_dev = jax.device_put(stacked, sharding)
    valid_dev = jax.device_put(pair_valid, sharding)
    corr_sum, corr_count, corr_max, s2n = jax.jit(run)(stacked_dev, valid_dev)
    corr_max = np.asarray(corr_max).reshape(-1, n_rows, n_cols)[:n_pairs]
    s2n = np.asarray(s2n).reshape(-1, n_rows, n_cols)[:n_pairs]
    return np.asarray(corr_sum), np.asarray(corr_count), corr_max, s2n


def piv_multipass_sharded(
    imgs: np.ndarray,
    window_size: Tuple[int, int],
    overlap: Tuple[int, int],
    search_area_size: Optional[Tuple[int, int]] = None,
    mesh: Optional[Mesh] = None,
    passes: int = 2,
    signal_threshold: Optional[float] = None,
    corr_method: str = "auto",
):
    """Multi-pass deformation PIV sharded over frame pairs.

    Pairs stay embarrassingly parallel across passes (each pair's
    deformation depends only on its own displacement history), so the whole
    cascade runs per shard with no collectives — same halo construction as
    :func:`piv_pairs_sharded` (BASELINE config 4: multi-pass adaptive PIV on
    a device mesh).

    Returns (u, v, corr_max, s2n) each [n_pairs, n_rows, n_cols] (numpy).
    """
    from ..ops import multipass

    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    sas = tuple(win._as2(window_size if search_area_size is None else search_area_size))
    ov = tuple(win._as2(overlap))
    dim_size = imgs.shape[-2:]
    n_rows, n_cols = win.get_field_shape(dim_size, sas, ov)
    stacked, n_pairs = pad_pairs_for_devices(np.asarray(imgs), n_dev)
    method = piv_ops.corr_route(corr_method)

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P("pairs"), out_specs=P("pairs"))
    def run(frames_dev):
        u, v, cmax, s2n = multipass.piv_multipass(
            frames_dev[0], dim_size, sas, ov, n_rows, n_cols,
            passes=passes, signal_threshold=signal_threshold, corr_method=method,
        )
        return u[None], v[None], cmax[None], s2n[None]

    sharding = NamedSharding(mesh, P("pairs"))
    stacked_dev = jax.device_put(stacked, sharding)
    u, v, cmax, s2n = jax.jit(run)(stacked_dev)
    return tuple(np.asarray(a).reshape(-1, n_rows, n_cols)[:n_pairs] for a in (u, v, cmax, s2n))


def pad_rows_for_devices(
    imgs: np.ndarray, n_dev_rows: int, wy: int, step_y: int, n_rows: int
) -> Tuple[np.ndarray, int]:
    """Slice frames into per-device row slabs [Dr, T, H_slab, W].

    Bands overlap by (wy - step_y) rows at 50% overlap, so adjacent slabs
    carry a halo built host-side from overlapping slices (same approach as
    the pair axis; no device-side halo exchange needed). The band count is
    padded to a multiple of n_dev_rows with bottom padding; padded bands are
    dropped by the caller.
    """
    nb_per = -(-n_rows // n_dev_rows)
    nb_total = nb_per * n_dev_rows
    h_slab = (nb_per - 1) * step_y + wy
    h_needed = (nb_total - 1) * step_y + wy
    if imgs.shape[-2] < h_needed:
        pad = h_needed - imgs.shape[-2]
        imgs = np.concatenate(
            [imgs, np.zeros(imgs.shape[:-2] + (pad,) + imgs.shape[-1:], imgs.dtype)], axis=-2
        )
    slabs = [
        imgs[..., d * nb_per * step_y : d * nb_per * step_y + h_slab, :]
        for d in range(n_dev_rows)
    ]
    return np.stack(slabs), nb_per


def piv_pairs_sharded_2d(
    imgs: np.ndarray,
    window_size: Tuple[int, int],
    overlap: Tuple[int, int],
    search_area_size: Optional[Tuple[int, int]] = None,
    mesh: Optional[Mesh] = None,
    signal_threshold: Optional[float] = None,
    corr_method: str = "auto",
):
    """Per-timestep PIV over a 2-D (pairs, rows) device mesh.

    SURVEY §2.4 bullet 2: for large rasters (4K frames) the window-grid row
    bands shard across the second mesh axis — tiles are cut on window
    boundaries with a (wy - step_y)-row host-side halo, so the per-device
    kernel is embarrassingly parallel and the path needs NO collectives.
    Composes with pair sharding on the first axis.

    Returns (u, v, corr_max, s2n) each [n_pairs, n_rows, n_cols] (numpy).
    """
    if mesh is None:
        devs = np.asarray(jax.devices())
        mesh = Mesh(devs.reshape(-1, 2), ("pairs", "rows")) if devs.size % 2 == 0 else Mesh(
            devs.reshape(-1, 1), ("pairs", "rows")
        )
    dp, dr = mesh.devices.shape
    sas = tuple(win._as2(window_size if search_area_size is None else search_area_size))
    ov = tuple(win._as2(overlap))
    dim_size = imgs.shape[-2:]
    n_rows, n_cols = win.get_field_shape(dim_size, sas, ov)
    row0, _ = win.get_window_starts(dim_size, sas, ov)
    step_y = piv_ops._strided_axis_starts(np.asarray(row0), sas[0])
    if step_y is None:
        raise ValueError("2-D sharding needs a uniform strided window grid")
    method = piv_ops.corr_route(corr_method)

    stacked_pairs, n_pairs = pad_pairs_for_devices(np.asarray(imgs), dp)  # [Dp, P+1, H, W]
    slabs, nb_per = pad_rows_for_devices(stacked_pairs, dr, sas[0], step_y, n_rows)
    # [Dr, Dp, P+1, Hs, W] -> [Dp, Dr, P+1, Hs, W]
    slabs = np.moveaxis(slabs, 0, 1)
    slab_dims = slabs.shape[-2:]

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=P("pairs", "rows"), out_specs=P("pairs", "rows")
    )
    def run(frames_dev):
        frames = frames_dev[0, 0]  # [P+1, Hs, W]
        u, v, cmax, s2n = piv_ops.piv_pairs(
            frames, slab_dims, sas, ov, nb_per, n_cols, signal_threshold, method
        )
        return u[None, None], v[None, None], cmax[None, None], s2n[None, None]

    sharding = NamedSharding(mesh, P("pairs", "rows"))
    u, v, cmax, s2n = jax.jit(run)(jax.device_put(slabs, sharding))

    def fix(a):
        a = np.asarray(a)  # [Dp, Dr, P, nb_per, n_cols]
        a = np.concatenate([a[:, d] for d in range(dr)], axis=2)  # rows back together
        a = a.reshape(-1, a.shape[-2], a.shape[-1])
        return a[:n_pairs, :n_rows]

    return fix(u), fix(v), fix(cmax), fix(s2n)
