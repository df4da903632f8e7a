"""Plain float64 NumPy PIV: the reference the XLA path is checked against.

Written without :mod:`pyorc_tpu.ops.piv`: windows are a strided view of the
frame, planes come from ``np.fft`` in float64, and the sub-pixel fit is the
textbook three-point formula. It implements the same contract: windows of
``w`` pixels every ``w - overlap`` pixels from the top-left corner; circular
cross-correlation of the demeaned windows, fftshifted, divided by
``n_pix * std_a * std_b``, negatives clipped to 0 and zero-variance windows
zeroed; a 3-point Gaussian peak fit clamped one pixel inside the plane; ``u``
is +column and ``v`` is -row displacement. The tests and ``chip_smoke.py``
compare the device results with it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["window_stack", "corr_planes", "peak_gap", "displacement", "ensemble"]


def window_stack(img: np.ndarray, window: int, overlap: int) -> np.ndarray:
    """[n_rows, n_cols, window, window] windows of one frame (a strided view)."""
    step = window - overlap
    return np.lib.stride_tricks.sliding_window_view(img, (window, window))[::step, ::step]


def corr_planes(img_a: np.ndarray, img_b: np.ndarray, window: int, overlap: int) -> np.ndarray:
    """Normalised correlation planes [n_rows, n_cols, window, window]."""
    a = window_stack(np.asarray(img_a, np.float64), window, overlap)
    b = window_stack(np.asarray(img_b, np.float64), window, overlap)
    a = a - a.mean(axis=(-2, -1), keepdims=True)
    b = b - b.mean(axis=(-2, -1), keepdims=True)
    sa = a.std(axis=(-2, -1))
    sb = b.std(axis=(-2, -1))
    spec = np.conj(np.fft.fft2(a)) * np.fft.fft2(b)
    plane = np.fft.fftshift(np.real(np.fft.ifft2(spec)), axes=(-2, -1))
    plane = plane / np.maximum(window * window * sa * sb, 1e-10)[..., None, None]
    plane = np.maximum(plane, 0.0)
    valid = (sa > 1e-6) & (sb > 1e-6)
    return np.where(valid[..., None, None], plane, 0.0)


def peak_gap(planes: np.ndarray) -> np.ndarray:
    """Highest minus second-highest value of each plane: a window whose gap
    is tiny has no unambiguous peak, and rounding may pick either."""
    flat = np.sort(planes.reshape(planes.shape[:-2] + (-1,)), axis=-1)
    return flat[..., -1] - flat[..., -2]


def displacement(planes: np.ndarray):
    """(u, v) in pixels from planes [..., wy, wx] by a 3-point Gaussian fit."""
    wy, wx = planes.shape[-2:]
    lead = planes.shape[:-2]
    p = planes.reshape(-1, wy, wx)
    valid = np.isfinite(p).any(axis=(1, 2))
    iy, ix = np.divmod(np.argmax(np.where(np.isfinite(p), p, -np.inf).reshape(len(p), -1), axis=1), wx)
    iy = np.clip(iy, 1, wy - 2)
    ix = np.clip(ix, 1, wx - 2)
    n = np.arange(len(p))
    eps = 1e-10

    def fit(lo, mid, hi):
        lo, mid, hi = (np.log(np.maximum(c, eps)) for c in (lo, mid, hi))
        den = 2 * lo - 4 * mid + 2 * hi
        den = np.where(np.abs(den) < eps, -eps, den)
        d = (lo - hi) / den
        return np.clip(np.where(np.isfinite(d), d, 0.0), -1.0, 1.0)

    dy = fit(p[n, iy - 1, ix], p[n, iy, ix], p[n, iy + 1, ix])
    dx = fit(p[n, iy, ix - 1], p[n, iy, ix], p[n, iy, ix + 1])
    u = np.where(valid, ix + dx - wx // 2, np.nan)
    v = np.where(valid, -(iy + dy - wy // 2), np.nan)
    return u.reshape(lead), v.reshape(lead)


def ensemble(frames: np.ndarray, window: int, overlap: int, corr_min: float = 0.2, s2n_min: float = 3.0):
    """Ensemble correlation over consecutive pairs with the (corr_min,
    s2n_min) gate per plane.

    Returns (corr_sum [n_rows, n_cols, w, w], count [n_rows, n_cols],
    corr_max and s2n [n_pairs, n_rows, n_cols]) before gating.
    """
    corr_sum = count = 0.0
    cmaxs, s2ns = [], []
    for a, b in zip(frames[:-1], frames[1:]):
        planes = corr_planes(a, b, window, overlap)
        cmax = planes.max(axis=(-2, -1))
        with np.errstate(invalid="ignore", divide="ignore"):
            s2n = cmax / planes.mean(axis=(-2, -1))
        ok = (cmax >= corr_min) & (s2n >= s2n_min) & np.isfinite(s2n)
        corr_sum = corr_sum + np.where(ok[..., None, None], planes, 0.0)
        count = count + ok
        cmaxs.append(cmax)
        s2ns.append(s2n)
    return corr_sum, count, np.stack(cmaxs), np.stack(s2ns)
