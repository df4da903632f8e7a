"""Frames accessor: preprocessing filters, orthorectification, PIV entry point.

API-parity port of the reference accessor (reference ``pyorc/api/frames.py``),
with the compute substrate swapped: per-frame dask/OpenCV calls become batched
jitted XLA ops (:mod:`pyorc_tpu.ops.filters`, :mod:`pyorc_tpu.ops.ortho`) and
the PIV hot loop streams through the device (:mod:`pyorc_tpu.velocimetry`).
"""

from __future__ import annotations

import copy
import os
from typing import Optional

import logging

import numpy as np

from .. import const, helpers, ndx
from ..ops import filters as flt
from ..ops import ortho as ortho_ops
from ..ops import windows as win
from .orcbase import ORCBase

__all__ = ["Frames"]


def _put_time_sharded(chunk):
    """device_put a frame batch, sharded over the time axis when a mesh is
    available — per-frame filters and the ortho gather are embarrassingly
    parallel, so multi-chip runs preprocess on every chip instead of one."""
    import jax

    devices = jax.devices()
    n = getattr(chunk, "shape", (0,))[0]
    if len(devices) > 1 and n >= len(devices) and n % len(devices) == 0:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(np.asarray(devices), ("t",))
        return jax.device_put(chunk, NamedSharding(mesh, P("t")))
    return jax.device_put(chunk)


@ndx.register_dataarray_accessor("frames")
class Frames(ORCBase):
    """Frame-stack functionality on an ndx.DataArray."""

    def __init__(self, obj):
        super().__init__(obj)

    @property
    def is_projected(self) -> bool:
        return all(coord in self._obj.coords for coord in ["xs", "ys"])

    # -- device batching helper ------------------------------------------------------

    @staticmethod
    def _put_time_sharded(chunk):
        return _put_time_sharded(chunk)

    def _map_device(self, fn, batch: int = 64, out_dtype=None, halo=None, rebase=None, host_stats=None):
        """Apply a jitted per-frame op over the frame stack.

        Lazy-backed stacks (video decode) stay LAZY: the op is appended to
        the LazyFrames op chain and runs per batch inside the prefetch
        thread, so decode -> filter chains stream through the PIV loop
        without materializing the whole (potentially tens-of-GB) stack.
        In-memory stacks are mapped eagerly in device batches.

        ``halo``/``rebase`` declare crop compatibility for the upload-crop
        optimization in :meth:`project`: ``halo`` is the op's spatial support
        radius in pixels (0 for elementwise ops, the stencil radius for
        convolutions, None = cropping not supported); ``rebase`` optionally
        builds a replacement chunk-fn for input frames cropped to
        ``[r0:r1, c0:c1]`` (needed when the op captures a full-frame constant,
        e.g. normalize's mean image). ``rebase=None`` with a halo means the
        same fn is shape-agnostic and runs on cropped chunks unchanged.
        ``host_stats`` declares a GLOBAL per-frame dependency that cropping
        would break (e.g. normalize's rescale extrema): a host fn
        ``(full_batch) -> aux`` evaluated on the decoded batch BEFORE the
        crop; the op returned by ``rebase`` must then accept ``(chunk, aux)``.
        """
        import jax

        from .video import LazyFrames

        data = self._obj.data
        if isinstance(data, LazyFrames):
            op = lambda chunk: fn(_put_time_sharded(chunk))
            if halo is not None:
                op._pyorc_halo = int(halo)
                op._pyorc_rebase = rebase
                op._pyorc_host_stats = host_stats
            return data.with_op(op, dtype=out_dtype)
        n = data.shape[0]
        outs = []
        for start in range(0, n, batch):
            chunk = np.asarray(data[start : min(start + batch, n)])
            outs.append(np.asarray(fn(jax.device_put(chunk))))
        return np.concatenate(outs, axis=0)

    def _with_data(self, data, dims=None, drop_time: int = 0) -> ndx.DataArray:
        """New frames DataArray with same coords/attrs (optionally first frames dropped)."""
        obj = self._obj
        dims = obj.dims if dims is None else dims
        new = ndx.DataArray(data, dims=dims, name=obj.name, attrs=dict(obj.attrs), fastpath=True)
        for k, c in obj._coords.items():
            if drop_time and "time" in c.dims:
                new._coords[k] = c.isel(time=slice(drop_time, None))
            else:
                new._coords[k] = c
        return new

    # -- filters ------------------------------------------------------------

    def normalize(self, samples: int = 15) -> ndx.DataArray:
        """Remove the temporal mean of sampled frames. Reference frames.py:279-306."""
        import jax

        n = self._obj.shape[0]
        time_interval = round(n / samples)
        assert time_interval != 0, f"Amount of frames is too small to provide {samples} samples"
        sampled = np.asarray(self._obj.data[::time_interval]).astype(np.float32)
        # device-put once: the op below runs per streamed chunk, and the mean
        # image is tens of MB at 4K — re-uploading it each chunk would rival
        # the filter's own cost
        mean_h = sampled.mean(axis=0).astype(np.float32)
        mean = jax.device_put(mean_h)

        def host_stats(batch):
            # per-frame rescale extrema of (frame - mean) over the FULL frame,
            # in float32 — bit-identical to the device reduction (subtract and
            # min/max round identically and are order-independent). Framewise
            # loop keeps the float32 temp at one frame, not one batch.
            mins, maxs = [], []
            for f in batch:
                red = np.asarray(f, dtype=np.float32) - mean_h
                mins.append(red.min(axis=(-2, -1), keepdims=True))
                maxs.append(red.max(axis=(-2, -1), keepdims=True))
            return np.stack(mins), np.stack(maxs)

        def rebase(r0, r1, c0, c1):
            mean_c = jax.device_put(np.ascontiguousarray(mean_h[r0:r1, c0:c1]))

            def run(chunk, aux):
                fmin, fmax = aux
                return flt.normalize_with_stats(
                    _put_time_sharded(chunk), mean_c, jax.device_put(fmin), jax.device_put(fmax)
                )

            return run

        out = self._map_device(
            lambda f: flt.normalize_with_mean(f, mean),
            halo=0,
            rebase=rebase,
            host_stats=host_stats,
        )
        return self._with_data(out)

    def edge_detect(self, wdw_1: int = 1, wdw_2: int = 2) -> ndx.DataArray:
        stride_1 = wdw_1 * 2 + 1
        stride_2 = wdw_2 * 2 + 1
        out = self._map_device(
            lambda f: flt.edge_detect(f, stride_1, stride_2),
            out_dtype=np.float32,
            halo=max(stride_1, stride_2) // 2,
        )
        if isinstance(out, np.ndarray):
            out = out.astype(np.float32)
        return self._with_data(out)

    def minmax(self, min: float = -np.inf, max: float = np.inf) -> ndx.DataArray:
        dtype = self._obj.dtype
        out = self._map_device(
            lambda f: flt.minmax(f, float(min), float(max)).astype(dtype),
            out_dtype=dtype,
            halo=0,
        )
        if isinstance(out, np.ndarray):
            out = out.astype(dtype)
        return self._with_data(out)

    def range(self) -> ndx.DataArray:
        """Temporal intensity range per pixel (no time dimension)."""
        arr = np.asarray(self._obj.data)
        out = (arr.max(axis=0) - arr.min(axis=0)).astype(self._obj.dtype)
        new = self._with_data(out, dims=tuple(d for d in self._obj.dims if d != "time"))
        new._coords = {k: c for k, c in new._coords.items() if "time" not in c.dims}
        return new

    def reduce_rolling(self, samples: int = 25) -> ndx.DataArray:
        assert self._obj.shape[0] >= samples, f"Amount of frames is smaller than rolling of {samples} samples"
        import jax

        out = np.asarray(flt.reduce_rolling(jax.device_put(np.asarray(self._obj.data)), samples))
        return self._with_data(out)

    def time_diff(self, thres: float = 0.0, abs: bool = False) -> ndx.DataArray:
        import jax

        out = np.asarray(flt.time_diff(jax.device_put(np.asarray(self._obj.data)), float(thres), bool(abs)))
        new = self._with_data(out, drop_time=1)
        return new

    def smooth(self, wdw: int = 1) -> ndx.DataArray:
        stride = wdw * 2 + 1
        out = self._map_device(
            lambda f: flt.gaussian_blur(f, stride), out_dtype=np.float32, halo=stride // 2
        )
        if isinstance(out, np.ndarray):
            out = out.astype(np.float32)
        return self._with_data(out)

    # -- projection ------------------------------------------------------------

    def project(
        self,
        method: str = "numpy",
        resolution: Optional[float] = None,
        reducer: str = "mean",
    ) -> ndx.DataArray:
        """Orthorectify frames onto the water-surface plane grid.

        ``method="numpy"`` matches the reference's naming for the index-map
        projection path (reference frames.py:199-277, project.py:164-230); the
        per-frame work runs as a static-gather XLA kernel here.
        """
        if method not in ("numpy", "cv"):
            raise ValueError(f"Selected projection method {method} does not exist.")
        cc = copy.deepcopy(self.camera_config)
        if resolution is not None:
            cc.resolution = resolution
        shape = cc.shape
        y = np.flipud(np.linspace(cc.resolution / 2, cc.resolution * (shape[0] - 0.5), shape[0]))
        x = np.linspace(cc.resolution / 2, cc.resolution * (shape[1] - 0.5), shape[1])
        cols, rows = np.meshgrid(np.arange(len(x)), np.arange(len(y)))
        xs, ys = helpers.get_xs_ys(cols, rows, cc.transform)
        if hasattr(cc, "crs"):
            lons, lats = helpers.get_lons_lats(xs, ys, cc.crs)
        else:
            lons, lats = None, None
        coords = {"y": y, "x": x}
        z = cc.get_z_a(self.h_a)
        maps = ortho_ops.build_ortho_maps(cc, x, y, z, reducer=reducer)
        is_rgb = "rgb" in self._obj.dims
        src_dtype = self._obj.dtype

        from .video import LazyFrames

        data = self._obj.data

        # upload-crop: the ortho maps usually read a sub-rectangle of the
        # camera frame (the AOI bbox in pixel space). When every op already
        # on the lazy chain declares crop compatibility, crop each decoded
        # batch on the HOST to that box (padded by the ops' stencil halos),
        # rebase the maps and the ops, and upload only the cropped pixels —
        # bit-identical output, proportionally less host->device traffic.
        crop_slices = None
        if (
            isinstance(data, LazyFrames)
            and not os.environ.get("PYORC_TPU_NO_UPLOAD_CROP")
            and all(hasattr(op, "_pyorc_halo") for op in data._ops)
            # ops with a global (full-frame) dependency are only croppable in
            # first position, where their input — the decoded batch — still
            # exists to compute host stats on
            and not any(
                op._pyorc_host_stats is not None for op in data._ops[1:]
            )
        ):
            box = ortho_ops.source_bbox(maps)
            if box is not None:
                H, W = maps.shape_in
                halo = sum(op._pyorc_halo for op in data._ops)
                r0 = max(box[0] - halo, 0)
                r1 = min(box[1] + halo, H)
                c0 = max(box[2] - halo, 0)
                c1 = min(box[3] + halo, W)
                hc, wc = r1 - r0, c1 - c0
                if hc * wc <= 0.95 * H * W:
                    maps = ortho_ops.crop_maps(maps, r0, c0, hc, wc)
                    crop_slices = (r0, r1, c0, c1)

        def project_chunk(chunk):
            import jax.numpy as jnp

            if is_rgb:
                out = jnp.stack(
                    [ortho_ops.project_batch(chunk[..., b], maps) for b in range(chunk.shape[-1])],
                    axis=-1,
                )
            else:
                out = ortho_ops.project_batch(chunk, maps)
            return out

        if isinstance(data, LazyFrames):
            # projection rides the lazy op chain: decode -> filters -> ortho
            # stream per batch in the prefetch thread, staying device-resident
            import jax
            import jax.numpy as jnp

            if crop_slices is not None:
                r0, r1, c0, c1 = crop_slices
                stats0 = (
                    data._ops[0]._pyorc_host_stats if data._ops else None
                )

                def crop_op(batch):
                    aux = stats0(batch) if stats0 is not None else None
                    batch = batch[:, r0:r1, c0:c1]
                    if isinstance(batch, np.ndarray):
                        # contiguous host buffer keeps device_put on the fast path
                        batch = np.ascontiguousarray(batch)
                    return batch if aux is None else (batch, aux)

                rebased = [
                    op if getattr(op, "_pyorc_rebase", None) is None
                    else op._pyorc_rebase(r0, r1, c0, c1)
                    for op in data._ops
                ]
                if stats0 is not None:
                    # first op consumes (chunk, aux) — aux is its full-frame
                    # stats, computed by crop_op before pixels were dropped
                    reb0 = rebased[0]
                    rebased[0] = lambda payload: reb0(payload[0], payload[1])
                pre_shape = (r1 - r0, c1 - c0) + ((3,) if is_rgb else ())
                data = data.with_chain([crop_op] + rebased, frame_shape=pre_shape)

            fshape = (len(y), len(x), 3) if is_rgb else (len(y), len(x))
            out = data.with_op(
                lambda chunk: jnp.nan_to_num(project_chunk(_put_time_sharded(chunk))).astype(src_dtype),
                frame_shape=fshape,
                dtype=src_dtype,
            )
        else:
            n = data.shape[0]
            outs = []
            batch = 32
            for s in range(0, n, batch):
                chunk = np.asarray(data[s : min(s + batch, n)])
                outs.append(np.asarray(project_chunk(chunk)))
            out = np.concatenate(outs, axis=0)
            out = np.nan_to_num(out).astype(src_dtype)
        dims = ("time", "y", "x", "rgb") if is_rgb else ("time", "y", "x")
        da_proj = ndx.DataArray(
            out,
            dims=dims,
            coords={"time": self._obj["time"].values, **coords, **({"rgb": [0, 1, 2]} if is_rgb else {})},
            attrs=dict(self._obj.attrs),
            name="frames",
        )
        da_proj = da_proj.frames.add_xy_coords(
            {"xs": xs, "ys": ys, "lon": lons, "lat": lats}, coords, const.GEOGRAPHICAL_ATTRS
        )
        da_proj.attrs.update(camera_config=cc.to_json())
        return da_proj

    # -- PIV ------------------------------------------------------------

    def get_piv_coords(self, window_size, search_area_size, overlap):
        """Window-centre coordinates in all systems. Reference frames.py:47-112."""
        dim_size = self._obj.shape[1:3]
        cols_vector, rows_vector = win.get_rect_coordinates(
            dim_size=dim_size, window_size=window_size, search_area_size=search_area_size, overlap=overlap
        )
        cols, rows = np.meshgrid(cols_vector, rows_vector)
        x, y = helpers.get_axes(cols_vector, rows_vector, self._obj["x"].values, self._obj["y"].values)
        xs, ys = helpers.get_xs_ys(cols, rows, self.camera_config.transform)
        if hasattr(self.camera_config, "crs"):
            lons, lats = helpers.get_lons_lats(xs, ys, self.camera_config.crs)
        else:
            lons, lats = None, None
        z = self.camera_config.h_to_z(self.h_a)
        zs = np.ones(xs.shape) * z
        xp, yp = self.camera_config.project_grid(xs, ys, zs, swap_y_coords=True)
        coords = {"y": y, "x": x}
        mesh_coords = {"xp": xp, "yp": yp, "xs": xs, "ys": ys, "lon": lons, "lat": lats}
        return coords, mesh_coords

    def get_piv(
        self,
        window_size=None,
        overlap=None,
        engine: str = "jax",
        ensemble_corr: bool = False,
        **kwargs,
    ) -> ndx.Dataset:
        """PIV over projected frames -> Dataset(v_x, v_y, corr, s2n).

        Reference frames.py:114-197; ``engine`` accepts "jax" (device
        pipeline; "numba"/"numpy" are accepted as aliases for compatibility
        with reference recipes).
        """
        from .. import velocimetry as engine_mod

        camera_config = copy.deepcopy(self.camera_config)
        dt = self._obj["time"].diff(dim="time")
        if window_size is not None:
            camera_config.window_size = window_size
        window_size = (
            2 * (camera_config.window_size,)
            if isinstance(camera_config.window_size, int)
            else tuple(camera_config.window_size)
        )
        window_size = win.round_to_even(window_size)
        search_area_size = window_size
        if overlap is None:
            overlap = 2 * (int(round(camera_config.window_size) / 2),)
        coords, mesh_coords = self.get_piv_coords(window_size, search_area_size, overlap)
        if engine not in ("jax", "numba", "numpy"):
            raise ValueError(f"Selected PIV engine {engine} does not exist.")
        if engine != "jax":
            logging.getLogger(__name__).debug(
                "engine=%r is accepted for recipe compatibility but runs the JAX engine.",
                engine,
            )
        kwargs = {
            **kwargs,
            "search_area_size": search_area_size,
            "window_size": window_size,
            "overlap": overlap,
            "res_x": camera_config.resolution,
            "res_y": camera_config.resolution,
        }
        ds = engine_mod.get_piv(
            self._obj, coords["y"], coords["x"], dt, ensemble_corr=ensemble_corr, **kwargs
        )
        ds = ds.velocimetry.add_xy_coords(
            mesh_coords, coords, {**const.PERSPECTIVE_ATTRS, **const.GEOGRAPHICAL_ATTRS}
        )
        ds.attrs = dict(self._obj.attrs)
        ds.attrs.update(camera_config=camera_config.to_json())
        ds.velocimetry.set_encoding()
        return ds

    def get_stiv(
        self,
        centers,
        angle: float,
        length: float,
        n_samples: int = None,
        window: int = 0,
        refine: int = 2,
        min_coherence: float = None,
    ) -> ndx.Dataset:
        """Space-Time Image Velocimetry along flow-aligned search lines.

        A capability the reference lists as wished-for but does not implement
        (reference README.md:22); see :mod:`pyorc_tpu.ops.stiv`. Frames must
        be projected. For reliable streak angles pick ``n_samples`` so the
        expected displacement per frame stays under ~1.5 sample steps.

        Parameters
        ----------
        centers : [n_lines, 2] array
            line centre points (x, y) in the projected local coordinates
            (metres, same axes as the frames' x/y coords).
        angle : float
            flow direction in radians from +x toward +y (math convention).
        length : float
            search-line length in metres.
        n_samples : int, optional
            samples per line; default one per resolution step.
        window : int
            if > 0, returns a velocity profile along each line (dims
            ``(line, points)``) averaged over a box of this many samples.
        refine : int
            shear-refinement iterations for steep streaks.
        min_coherence : float, optional
            velocities whose coherence falls below this are set to NaN —
            where texture is weak or motion crosses the line, the streak
            angle (and hence v) is meaningless while coherence stays low.

        Returns
        -------
        ndx.Dataset with ``v`` (m/s, signed along the flow direction) and
        ``coherence`` (structure-tensor anisotropy in [0, 1], the STIV
        quality metric).
        """
        from ..ops import stiv as stiv_ops

        assert self.is_projected, "STIV requires projected frames (run frames.project() first)"
        camera_config = self.camera_config
        res = float(camera_config.resolution)
        x = self._obj["x"].values
        y = self._obj["y"].values
        centers = np.atleast_2d(np.asarray(centers, dtype=np.float64))
        cols_c = (centers[:, 0] - x[0]) / (x[1] - x[0])
        rows_c = (centers[:, 1] - y[0]) / (y[1] - y[0])
        if n_samples is None:
            n_samples = max(int(round(length / res)) + 1, 8)
        # y rows run opposite to +y: flip the angle's y component
        px_angle = np.arctan2(-np.sin(angle) * np.sign(y[0] - y[1]), np.cos(angle))
        rows, cols = stiv_ops.stiv_lines(
            np.stack([cols_c, rows_c], axis=1), px_angle, length / res, int(n_samples)
        )
        data = np.asarray(self._obj.values, dtype=np.float32)
        sti = stiv_ops.build_sti(data, rows, cols)
        step_px = (length / res) / (n_samples - 1)
        dt = float(np.mean(np.diff(self._obj["time"].values)))
        v, coh = stiv_ops.sti_velocity(sti, step_px, dt, int(window), int(refine))
        v = np.asarray(v) * res  # px/s -> m/s
        coh = np.asarray(coh)
        if min_coherence is not None:
            v = np.where(coh >= min_coherence, v, np.nan)
        dims = ("line", "points") if window and window > 0 else ("line",)
        coords = {"line": np.arange(centers.shape[0])}
        if len(dims) == 2:
            coords["points"] = np.arange(v.shape[1])
        ds = ndx.Dataset(
            {
                "v": (dims, v.astype(np.float32), {"units": "m s-1", "long_name": "STIV streamwise velocity"}),
                "coherence": (dims, coh.astype(np.float32), {"units": "", "long_name": "STIV coherence"}),
            },
            coords={
                **coords,
                "xc": (("line",), centers[:, 0]),
                "yc": (("line",), centers[:, 1]),
            },
            attrs=dict(self._obj.attrs),
        )
        return ds

    # -- output ------------------------------------------------------------

    def to_video(self, fn, video_format=None, fps=None, progress=True):
        """Write frames to an H.264 mp4 via the native libx264 encoder
        (reference frames.py:537-607 used cv2.VideoWriter; ``video_format``
        is accepted for signature compatibility and ignored — output is
        always H.264/mp4)."""
        from tqdm import tqdm

        from ..io.native_decoder import NativeVideoWriter

        if fps is None:
            diffs = np.diff(self._obj["time"].values)
            fps = 1.0 / diffs.mean() if len(diffs) else 25.0
        h, w = self._obj.shape[1], self._obj.shape[2]
        channels = 3 if self._obj.ndim == 4 else 1
        data = self._obj.data
        with NativeVideoWriter(str(fn), w, h, fps=float(fps), channels=channels) as out:
            for i in tqdm(range(self._obj.shape[0]), disable=not progress, desc="Writing video"):
                frame = np.asarray(data[i])
                if frame.ndim == 2:
                    f = frame.astype(np.float32)
                    fmin, fmax = np.nanmin(f), np.nanmax(f)
                    if fmax > fmin:
                        f = (f - fmin) / (fmax - fmin) * 255
                    frame = f
                out.write(frame.astype(np.uint8))

    def to_ani(
        self,
        fn,
        figure_kwargs=None,
        video_kwargs=None,
        anim_kwargs=None,
        progress_bar: bool = True,
        **kwargs,
    ):
        """Store an animation of the frames (reference frames.py:469-535)."""
        import matplotlib.animation as animation
        import matplotlib.pyplot as plt
        from tqdm import tqdm

        figure_kwargs = const.FIGURE_ARGS if figure_kwargs is None else figure_kwargs
        video_kwargs = const.VIDEO_ARGS if video_kwargs is None else video_kwargs
        anim_kwargs = const.ANIM_ARGS if anim_kwargs is None else anim_kwargs

        fig = plt.figure(**figure_kwargs)
        ax = plt.subplot(111)
        ax.set_axis_off()
        fig.subplots_adjust(left=0, bottom=0, right=1, top=1, wspace=None, hspace=None)
        data = self._obj.data
        n = data.shape[0]
        im = ax.imshow(np.asarray(data[0]), **kwargs)
        pbar = tqdm(total=n, desc="Writing animation", disable=not progress_bar, position=0, leave=True)

        def update(i):
            im.set_data(np.asarray(data[i]))
            pbar.update(1)
            return (im,)

        if animation.writers.is_available("ffmpeg"):
            anim = animation.FuncAnimation(fig, update, frames=n, **anim_kwargs)
            anim.save(str(fn), **video_kwargs)
        else:
            # no ffmpeg CLI on PATH: render each figure frame and encode
            # with cv2's VideoWriter instead
            import cv2

            fps = video_kwargs.get("fps", 25)
            writer = None
            for i in range(n):
                update(i)
                fig.canvas.draw()
                rgba = np.asarray(fig.canvas.buffer_rgba())
                bgr = cv2.cvtColor(rgba, cv2.COLOR_RGBA2BGR)
                if writer is None:
                    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
                    writer = cv2.VideoWriter(str(fn), fourcc, fps, (bgr.shape[1], bgr.shape[0]))
                writer.write(bgr)
            if writer is not None:
                writer.release()
        pbar.close()
        plt.close(fig)

    def to_geotiffs(
        self,
        prefix: str,
        start_frame: int = None,
        end_frame: int = None,
        stride: int = 1,
        suffix: str = ".tif",
        progress_bar: bool = True,
    ):
        """Export frames as individual GeoTIFFs (reference frames.py:550-607).

        Files are named ``{prefix}_{frame:04d}{suffix}``. Frames must be
        projected.
        """
        from tqdm import tqdm

        assert self.is_projected, "Frames must be projected before writing to GeoTIFF"
        n = self._obj.shape[0]
        start_frame = 0 if start_frame is None else start_frame
        end_frame = n if end_frame is None else min(end_frame, n)
        idxs = list(range(start_frame, end_frame, stride))
        fns = []
        for i in tqdm(idxs, desc="Writing GeoTIFFs", disable=not progress_bar, position=0, leave=True):
            fn = f"{prefix}_{i:04d}{suffix}"
            self.to_geotiff(fn, frame=i)
            fns.append(fn)
        return fns

    def to_geotiff(self, fn, frame: int = 0, crs=None):
        """Write one projected frame as a GeoTIFF (pure-Python writer)."""
        from ..io.geotiff import write_geotiff

        assert self.is_projected, "Frames must be projected before writing to GeoTIFF"
        cc = self.camera_config
        data = np.asarray(self._obj.isel(time=frame).values)
        crs = crs if crs is not None else getattr(cc, "crs", None)
        write_geotiff(fn, data, cc.transform, crs=crs)

    def plot(self, ax=None, mode: str = "local", **kwargs):
        """Plot a single frame (time must already be selected)."""
        from .plot import frames_plot

        return frames_plot(self._obj, ax=ax, mode=mode, **kwargs)
