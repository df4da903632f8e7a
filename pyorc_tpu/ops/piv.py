"""FFT-based PIV cross-correlation engine (JAX/XLA).

This replaces the reference's external native engine (``ffpiv.cross_corr`` +
``ffpiv.u_v_displacement``, numba + rocket-fft; reference call sites
``pyorc/velocimetry/ffpiv.py:222,324,450,471``) with a fully-jitted XLA
pipeline:

  window gather -> demean -> rfft2 -> conjugate spectral multiply -> irfft2
  -> fftshift -> normalize to correlation coefficients -> stats (max, s2n)
  -> 3-point Gaussian subpixel peak -> (u, v) displacements

Everything is static-shaped and batched over (frame-pairs x windows), so XLA
fuses the elementwise chains around the FFTs (cuFFT on a GPU); frame pairs
are embarrassingly parallel and can be sharded over devices (see
:mod:`pyorc_tpu.parallel`). FP32 throughout — bf16 correlation fails the
sub-0.01 m/s velocity parity target, and every matrix product runs at
``Precision.HIGHEST`` so a GPU never drops to TF32. :func:`corr_route` is the
one place that picks the correlation method for the running backend.

Semantics notes (ffpiv's internals are not part of this repo's reference
mount, so the contract is defined here and validated by synthetic-shift
tests): correlation planes are normalized to Pearson-style coefficients
(divide by n_pix * sigma_a * sigma_b), so ``corr_max`` is ~<= 1 and the
reference's default thresholds (corr_min=0.2, s2n_min=3) keep their meaning;
``u`` is +column displacement, ``v`` is -row displacement (towards +y on the
projected grid whose y axis decreases with row index, reference
``pyorc/api/frames.py:240``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import windows as win

__all__ = [
    "extract_windows",
    "cross_corr",
    "corr_stats",
    "u_v_displacement",
    "subpixel_peak",
    "piv_pairs",
    "piv_ensemble_scan",
    "corr_route",
]


def _strided_axis_starts(starts: np.ndarray, w: int):
    """The grid step if ``starts`` form an arithmetic grid whose step divides
    ``w`` (an int), else None."""
    if len(starts) < 2:
        return None
    step = int(starts[1] - starts[0])
    if step <= 0 or not np.all(np.diff(starts) == step):
        return None
    if w % step != 0:
        return None
    return step


def extract_windows(frames: jnp.ndarray, row0: np.ndarray, col0: np.ndarray, wy: int, wx: int) -> jnp.ndarray:
    """Gather interrogation windows from frames.

    Fast path: for the standard uniform grid whose step divides the window
    size (e.g. 50% overlap), windows are assembled from ``w//step`` shifted
    block reshapes per axis — pure reshapes/slices instead of gathers, which
    XLA fuses into plain copies.

    Parameters
    ----------
    frames : jnp.ndarray [..., H, W]
        one or more frames (leading axes arbitrary).
    row0, col0 : np.ndarray
        top-left offsets of the window bands per axis (static).
    wy, wx : int
        window height/width.

    Returns
    -------
    jnp.ndarray [..., n_rows*n_cols, wy, wx]
    """
    lead = frames.shape[:-2]
    n_rows, n_cols = len(row0), len(col0)
    step_y = _strided_axis_starts(np.asarray(row0), wy)
    step_x = _strided_axis_starts(np.asarray(col0), wx)
    if step_y is not None and step_x is not None:
        out = _extract_windows_reshape(frames, row0, col0, wy, wx, step_y, step_x)
    else:
        iy = (np.asarray(row0)[:, None] + np.arange(wy)[None, :]).astype(np.int32)
        ix = (np.asarray(col0)[:, None] + np.arange(wx)[None, :]).astype(np.int32)
        out = jnp.take(frames, jnp.asarray(iy.ravel()), axis=-2)
        out = jnp.take(out, jnp.asarray(ix.ravel()), axis=-1)
        out = out.reshape(lead + (n_rows, wy, n_cols, wx))
        out = jnp.moveaxis(out, -2, -3)
    return out.reshape(lead + (n_rows * n_cols, wy, wx))


def _extract_windows_reshape(frames, row0, col0, wy, wx, step_y, step_x):
    """Shifted-block-reshape window extraction (no gathers)."""
    lead = frames.shape[:-2]
    n_rows, n_cols = len(row0), len(col0)
    ky = wy // step_y  # number of shifted block phases per axis
    kx = wx // step_x

    # per phase p in 0..k-1, starts row0[p::k] are w-strided: one slice+reshape each
    phases_y = []
    for p in range(ky):
        starts = row0[p::ky]
        if len(starts) == 0:
            continue
        s0 = int(starts[0])
        cnt = len(starts)
        sl = jax.lax.slice_in_dim(frames, s0, s0 + cnt * wy, axis=frames.ndim - 2)
        sl = sl.reshape(lead + (cnt, wy, frames.shape[-1]))
        phases_y.append((p, sl))
    # interleave phases back into row order
    y_blocks = [None] * n_rows
    for p, sl in phases_y:
        for i in range(sl.shape[-3]):
            y_blocks[p + i * ky] = jax.lax.index_in_dim(sl, i, axis=sl.ndim - 3, keepdims=False)
    rows_stack = jnp.stack(y_blocks, axis=len(lead))  # [..., n_rows, wy, W]

    phases_x = []
    for p in range(kx):
        starts = col0[p::kx]
        if len(starts) == 0:
            continue
        s0 = int(starts[0])
        cnt = len(starts)
        sl = jax.lax.slice_in_dim(rows_stack, s0, s0 + cnt * wx, axis=rows_stack.ndim - 1)
        sl = sl.reshape(lead + (n_rows, wy, cnt, wx))
        phases_x.append((p, sl))
    x_blocks = [None] * n_cols
    for p, sl in phases_x:
        for i in range(sl.shape[-2]):
            x_blocks[p + i * kx] = jax.lax.index_in_dim(sl, i, axis=sl.ndim - 2, keepdims=False)
    out = jnp.stack(x_blocks, axis=len(lead) + 1)  # [..., n_rows, n_cols, wy, wx]
    return out


_DFT_CACHE = {}


def _dft_mats(n: int):
    """Real/imag parts of the n-point DFT matrix (cached, float32)."""
    if n not in _DFT_CACHE:
        k = np.arange(n, dtype=np.float64)
        ang = -2.0 * np.pi * k[:, None] * k[None, :] / n
        _DFT_CACHE[n] = (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))
    return _DFT_CACHE[n]


# Correlation method per supported backend. "fft" is XLA's FFT (cuFFT on a
# GPU); "matmul" is the DFT written as dense products at Precision.HIGHEST.
# The GPU entry is the faster of the two on an H100 at 16-64 px windows on
# 1080p frames, as timed by chip_smoke.py (phase 4); see PERF.md.
_CORR_METHODS = {"cpu": "fft", "gpu": "fft"}


def corr_route(corr_method: str = "auto") -> str:
    """The correlation method the XLA PIV path runs on this backend.

    ``corr_method`` "auto" takes the backend's entry in ``_CORR_METHODS``; an
    explicit "fft" or "matmul" wins. A backend other than cpu or gpu raises.
    """
    platform = jax.default_backend()
    if platform not in _CORR_METHODS:
        raise RuntimeError(
            f"unsupported JAX backend {platform!r}: pyorc_tpu runs on {sorted(_CORR_METHODS)}"
        )
    if corr_method == "auto":
        return _CORR_METHODS[platform]
    if corr_method not in ("fft", "matmul"):
        raise ValueError(f"corr_method must be 'auto', 'fft' or 'matmul', got {corr_method!r}")
    return corr_method


def _corr_raw_matmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Circular cross-correlation of demeaned windows via matmul-DFT.

    The 2-D DFT of each window is expressed as dense [n, n] matrix products
    at ``Precision.HIGHEST`` (float32 throughout; a GPU would otherwise run
    them in TF32, which keeps about three decimal digits). a, b: [..., wy, wx]
    float32.
    """
    wy, wx = a.shape[-2], a.shape[-1]
    cy, sy = (jnp.asarray(m) for m in _dft_mats(wy))
    cx, sx = (jnp.asarray(m) for m in _dft_mats(wx))
    mm = functools.partial(
        jnp.matmul, precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32
    )

    def dft2(v):
        # right multiply: columns transform. P + iQ = v @ (Cx + iSx)^T
        p = mm(v, cx.T)
        q = mm(v, sx.T)
        # left multiply: (Cy + iSy) @ (P + iQ)
        return mm(cy, p) - mm(sy, q), mm(cy, q) + mm(sy, p)

    a_re, a_im = dft2(a)
    b_re, b_im = dft2(b)
    # spectral product conj(A) * B
    s_re = a_re * b_re + a_im * b_im
    s_im = a_re * b_im - a_im * b_re
    # inverse DFT: (1/N) conj(F_y) @ S @ conj(F_x)^T, real part only
    u_re = mm(cy, s_re) + mm(sy, s_im)
    u_im = mm(cy, s_im) - mm(sy, s_re)
    v_re = mm(u_re, cx.T) + mm(u_im, sx.T)
    return v_re / (wy * wx)


def _normalized_corr_planes(win_a: jnp.ndarray, win_b: jnp.ndarray, corr_method: str = "fft") -> jnp.ndarray:
    """Circular normalized cross-correlation planes for window pairs.

    win_a, win_b: [..., wy, wx] float32. Returns fftshifted planes, same shape.
    """
    wy, wx = win_a.shape[-2], win_a.shape[-1]
    n_pix = wy * wx
    a = win_a - jnp.mean(win_a, axis=(-2, -1), keepdims=True)
    b = win_b - jnp.mean(win_b, axis=(-2, -1), keepdims=True)
    sa = jnp.sqrt(jnp.mean(a * a, axis=(-2, -1)))
    sb = jnp.sqrt(jnp.mean(b * b, axis=(-2, -1)))
    if corr_method == "matmul":
        corr = _corr_raw_matmul(a, b)
    else:
        fa = jnp.fft.rfft2(a)
        fb = jnp.fft.rfft2(b)
        corr = jnp.fft.irfft2(jnp.conj(fa) * fb, s=(wy, wx))
    corr = jnp.fft.fftshift(corr, axes=(-2, -1))
    denom = n_pix * sa * sb
    corr = corr / jnp.maximum(denom, 1e-10)[..., None, None]
    # clip negatives: a demeaned circular-correlation plane sums to exactly 0,
    # so peak-to-mean s2n is only meaningful on the non-negative plane (this
    # also matches the scale of the reference outputs' corr/s2n variables)
    corr = jnp.maximum(corr, 0.0)
    # kill zero-variance windows (uniform intensity -> no signal)
    valid = (sa > 1e-6) & (sb > 1e-6)
    return jnp.where(valid[..., None, None], corr, 0.0)


def cross_corr(
    imgs: jnp.ndarray,
    window_size: Tuple[int, int],
    overlap: Tuple[int, int],
    search_area_size: Optional[Tuple[int, int]] = None,
    normalize: bool = False,
    signal_threshold: Optional[float] = None,
    corr_method: str = "auto",
) -> Tuple[np.ndarray, np.ndarray, jnp.ndarray]:
    """Windowed FFT cross-correlation over all consecutive frame pairs.

    Drop-in for the reference's ``ffpiv.cross_corr`` contract
    (reference ``pyorc/velocimetry/ffpiv.py:222-231``).

    Parameters
    ----------
    imgs : [T, H, W] array (uint8 or float)
    window_size, overlap, search_area_size : (int, int)
    normalize : bool
        if set, window intensities are standardized before correlation
        (the correlation planes are always coefficient-normalized).
    signal_threshold : float, optional
        windows whose fraction of non-zero pixels falls below this threshold
        get NaN correlation planes (compute-all + mask keeps shapes static,
        with no data-dependent skipping).

    Returns
    -------
    (x, y, corr) : window-centre cols, rows and [T-1, n_windows, wy, wx] planes.
    """
    sas = window_size if search_area_size is None else search_area_size
    dim_size = imgs.shape[-2:]
    cols, rows = win.get_rect_coordinates(dim_size, window_size, sas, overlap)
    corr = _cross_corr_jit(
        jnp.asarray(imgs),
        dim_size,
        tuple(win._as2(sas)),
        tuple(win._as2(overlap)),
        bool(normalize),
        None if signal_threshold is None else float(signal_threshold),
        corr_route(corr_method),
    )
    return cols, rows, corr


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _cross_corr_jit(imgs, dim_size, sas, overlap, normalize, signal_threshold, corr_method="fft"):
    row0, col0 = win.get_window_starts(dim_size, sas, overlap)
    frames = imgs.astype(jnp.float32)
    # the named scopes label the device kernels in a profiler trace
    # (bench.py --trace reduces a trace to these three shares)
    with jax.named_scope("window_extract"):
        w = extract_windows(frames, row0, col0, sas[0], sas[1])  # [T, nw, wy, wx]
    if normalize:
        mu = jnp.mean(w, axis=(-2, -1), keepdims=True)
        sd = jnp.std(w, axis=(-2, -1), keepdims=True)
        w = (w - mu) / jnp.maximum(sd, 1e-6)
    with jax.named_scope("correlate"):
        corr = _normalized_corr_planes(w[:-1], w[1:], corr_method)
    if signal_threshold is not None:
        signal = jnp.mean(w > 0, axis=(-2, -1))  # fraction of non-zero pixels
        pair_signal = jnp.minimum(signal[:-1], signal[1:])
        corr = jnp.where(pair_signal[..., None, None] >= signal_threshold, corr, jnp.nan)
    return corr


def corr_stats(corr: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(corr_max, s2n) per plane; s2n = max / mean (reference ffpiv.py:235-236)."""
    corr_max = jnp.nanmax(corr, axis=(-2, -1))
    corr_mean = jnp.nanmean(corr, axis=(-2, -1))
    s2n = corr_max / corr_mean
    return corr_max, s2n


def subpixel_peak(corr: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Subpixel peak location per correlation plane via 3-point Gaussian fit.

    corr: [..., wy, wx]. Returns (row_peak, col_peak) as float, measured from
    the top-left of the plane. Fully vectorized: argmax + one-pixel-neighbour
    gather + closed-form Gaussian interpolation (no data-dependent control
    flow, so it stays one static-shaped XLA program).
    """
    wy, wx = corr.shape[-2], corr.shape[-1]
    flat = corr.reshape(corr.shape[:-2] + (wy * wx,))
    flat = jnp.where(jnp.isnan(flat), -jnp.inf, flat)
    idx = jnp.argmax(flat, axis=-1)
    iy = idx // wx
    ix = idx % wx
    # clamp peaks at borders so the 3-point stencil stays in range
    iy_c = jnp.clip(iy, 1, wy - 2)
    ix_c = jnp.clip(ix, 1, wx - 2)

    def take_at(dy, dx):
        lin = (iy_c + dy) * wx + (ix_c + dx)
        return jnp.take_along_axis(flat, lin[..., None], axis=-1)[..., 0]

    eps = 1e-10
    c0 = jnp.maximum(take_at(0, 0), eps)
    cl = jnp.maximum(take_at(0, -1), eps)
    cr = jnp.maximum(take_at(0, 1), eps)
    cu = jnp.maximum(take_at(-1, 0), eps)
    cd = jnp.maximum(take_at(1, 0), eps)
    log0 = jnp.log(c0)

    def safe_div(num, den):
        # the denominator is the (negative) log-curvature at the peak; keep its
        # sign and only guard against division by ~zero
        den = jnp.where(jnp.abs(den) < eps, -eps, den)
        return num / den

    dx = safe_div(jnp.log(cl) - jnp.log(cr), 2 * jnp.log(cl) - 4 * log0 + 2 * jnp.log(cr))
    dy = safe_div(jnp.log(cu) - jnp.log(cd), 2 * jnp.log(cu) - 4 * log0 + 2 * jnp.log(cd))
    dx = jnp.clip(jnp.nan_to_num(dx), -1.0, 1.0)
    dy = jnp.clip(jnp.nan_to_num(dy), -1.0, 1.0)
    # invalid planes (all -inf) -> NaN out
    invalid = ~jnp.isfinite(c0)
    row_peak = jnp.where(invalid, jnp.nan, iy_c.astype(jnp.float32) + dy)
    col_peak = jnp.where(invalid, jnp.nan, ix_c.astype(jnp.float32) + dx)
    return row_peak, col_peak


def u_v_displacement(corr: jnp.ndarray, n_rows: int, n_cols: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Displacements (u, v) in pixels from correlation planes.

    Drop-in for ``ffpiv.u_v_displacement`` (reference ffpiv.py:324,471):
    u = +column displacement, v = -row displacement; output [..., n_rows, n_cols].
    """
    wy, wx = corr.shape[-2], corr.shape[-1]
    row_peak, col_peak = subpixel_peak(corr)
    u = col_peak - wx // 2
    v = -(row_peak - wy // 2)
    lead = corr.shape[:-3]
    u = u.reshape(lead + (n_rows, n_cols))
    v = v.reshape(lead + (n_rows, n_cols))
    return u, v


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6, 7))
def _piv_pairs_jit(imgs, dim_size, sas, overlap, n_rows, n_cols, signal_threshold, corr_method):
    """Full per-pair PIV: frames [T,H,W] -> (u, v, corr_max, s2n), each [T-1, n_rows, n_cols].

    One fused jit: gather -> FFT corr -> stats -> subpixel. Displacements in
    pixels (caller scales by resolution/dt).
    """
    corr = _cross_corr_jit(imgs, dim_size, sas, overlap, False, signal_threshold, corr_method)
    with jax.named_scope("peak"):
        corr_max, s2n = corr_stats(corr)
        u, v = u_v_displacement(corr, n_rows, n_cols)
    corr_max = corr_max.reshape(-1, n_rows, n_cols)
    s2n = s2n.reshape(-1, n_rows, n_cols)
    return u, v, corr_max, s2n


def piv_pairs(imgs, dim_size, sas, overlap, n_rows, n_cols, signal_threshold=None, corr_method="auto"):
    """Full per-pair PIV (see _piv_pairs_jit); corr_method 'auto' takes
    :func:`corr_route`'s choice for the backend."""
    return _piv_pairs_jit(
        imgs, dim_size, sas, overlap, n_rows, n_cols, signal_threshold, corr_route(corr_method)
    )


# budget for the materialized correlation-plane tensor of one XLA dispatch;
# beyond this the window grid is processed in row-band strips (small windows
# on large frames otherwise blow up compile-time HLO temps — the 16 px 1080p
# configuration alone wants ~34 GB in one program)
_STRIP_CORR_BYTES = 256 * 1024 * 1024


def piv_pairs_strips(
    imgs,
    dim_size,
    sas,
    overlap,
    n_rows,
    n_cols,
    signal_threshold=None,
    corr_method="auto",
    corr_budget_bytes: Optional[int] = None,
):
    """Per-pair PIV with the window grid processed in row-band strips.

    Each strip is an image row band cut on window boundaries (uniform strided
    grids only — the same constraint as the 2-D mesh sharding), dispatched
    through :func:`piv_pairs` on the sliced frames. Strip heights are equal
    except possibly the last, so at most two XLA programs compile. Falls back
    to the single dispatch when the grid is non-uniform or already under
    budget.
    """
    if corr_budget_bytes is None:
        corr_budget_bytes = _STRIP_CORR_BYTES
    imgs = jnp.asarray(imgs)
    n_pairs = imgs.shape[0] - 1
    row0, col0 = win.get_window_starts(dim_size, sas, overlap)
    step_y = _strided_axis_starts(np.asarray(row0), sas[0])
    total_bytes = n_pairs * n_rows * n_cols * sas[0] * sas[1] * 4
    if step_y is None or total_bytes <= corr_budget_bytes:
        return piv_pairs(imgs, dim_size, sas, overlap, n_rows, n_cols, signal_threshold, corr_method)
    rows_per_strip = max(1, corr_budget_bytes // (n_pairs * n_cols * sas[0] * sas[1] * 4))
    outs = ([], [], [], [])
    for r0 in range(0, n_rows, rows_per_strip):
        r1 = min(r0 + rows_per_strip, n_rows)
        nb = r1 - r0
        top = int(row0[r0])
        h_band = (nb - 1) * step_y + sas[0]
        band = jax.lax.slice_in_dim(imgs, top, top + h_band, axis=imgs.ndim - 2)
        part = piv_pairs(
            band, (h_band, dim_size[1]), sas, overlap, nb, n_cols, signal_threshold, corr_method
        )
        for acc, a in zip(outs, part):
            acc.append(np.asarray(a))
    return tuple(np.concatenate(acc, axis=1) for acc in outs)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6, 7, 8, 9))
def _piv_ensemble_scan_jit(
    imgs,
    dim_size,
    sas,
    overlap,
    n_rows,
    n_cols,
    corr_min=0.2,
    s2n_min=3.0,
    signal_threshold=None,
    corr_method="fft",
):
    """Ensemble PIV over all frame pairs with a streaming accumulator.

    Mirrors the reference's ensemble path (``_get_ffpiv_mean``,
    reference ffpiv.py:182-376): per pair, planes failing (corr_min, s2n_min)
    are zeroed and excluded from the count; the accumulated mean plane is the
    caller's input to displacement extraction. Uses ``lax.scan`` over pairs
    so only one pair's correlation planes are live at a time instead of all
    of them.

    Returns (corr_sum [n_windows, wy, wx], corr_count [n_windows],
    corr_max [T-1, n_rows, n_cols], s2n [T-1, n_rows, n_cols]).
    """
    row0, col0 = win.get_window_starts(dim_size, sas, overlap)
    frames = imgs.astype(jnp.float32)
    w = extract_windows(frames, row0, col0, sas[0], sas[1])  # [T, nw, wy, wx]
    if signal_threshold is not None:
        signal = jnp.mean(w > 0, axis=(-2, -1))
    n_windows = w.shape[1]

    def step(carry, pair):
        corr_sum, corr_count = carry
        wa, wb, sig_ok = pair
        corr = _normalized_corr_planes(wa, wb, corr_method)
        corr = jnp.where(sig_ok[..., None, None], corr, jnp.nan)
        corr_max = jnp.nanmax(corr, axis=(-2, -1))
        s2n = corr_max / jnp.nanmean(corr, axis=(-2, -1))
        ok = (corr_max >= corr_min) & (s2n >= s2n_min) & jnp.isfinite(corr_max)
        corr = jnp.where(ok[..., None, None], corr, 0.0)
        corr_sum = corr_sum + jnp.nan_to_num(corr)
        corr_count = corr_count + ok.astype(jnp.float32)
        out_max = jnp.where(ok, corr_max, 0.0)
        out_s2n = jnp.where(ok, s2n, 0.0)
        return (corr_sum, corr_count), (out_max, out_s2n)

    if signal_threshold is not None:
        sig_ok = jnp.minimum(signal[:-1], signal[1:]) >= signal_threshold
    else:
        sig_ok = jnp.ones((w.shape[0] - 1, n_windows), dtype=bool)
    init = (
        jnp.zeros((n_windows, sas[0], sas[1]), dtype=jnp.float32),
        jnp.zeros((n_windows,), dtype=jnp.float32),
    )
    (corr_sum, corr_count), (corr_max, s2n) = jax.lax.scan(step, init, (w[:-1], w[1:], sig_ok))
    return corr_sum, corr_count, corr_max.reshape(-1, n_rows, n_cols), s2n.reshape(-1, n_rows, n_cols)


def piv_ensemble_scan(
    imgs, dim_size, sas, overlap, n_rows, n_cols, corr_min=0.2, s2n_min=3.0, signal_threshold=None, corr_method="auto"
):
    """Ensemble PIV (see _piv_ensemble_scan_jit); corr_method 'auto' takes
    :func:`corr_route`'s choice for the backend."""
    return _piv_ensemble_scan_jit(
        imgs, dim_size, sas, overlap, n_rows, n_cols, corr_min, s2n_min, signal_threshold,
        corr_route(corr_method),
    )
