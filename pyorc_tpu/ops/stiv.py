"""Space-Time Image Velocimetry (STIV) — batched XLA implementation.

A green-field capability: the reference lists STIV as a wished-for feature
(reference ``README.md:22``) but does not implement it. STIV measures the
streamwise surface velocity from the orientation of advected-texture streaks
in a space-time image (STI): pixels are sampled along a search line aligned
with the flow, stacked over time, and the dominant streak angle in the
resulting (time x space) image gives displacement per frame (Fujita et al.
2007 style gradient-tensor STIV).

All search lines are sampled in one batched bilinear
gather (``map_coordinates`` over a [n_lines, T, L] coordinate set), gradients
are central differences, and the orientation comes from a closed-form 2x2
structure-tensor eigen-analysis — one fused jit, no data-dependent control
flow. Windowed averaging of the tensor gives a velocity profile along each
line at essentially no extra cost.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["build_sti", "sti_velocity", "stiv_lines"]


def stiv_lines(centers_xy: np.ndarray, angle: float, length: float, n_samples: int):
    """Sample coordinates for STIV search lines.

    Parameters
    ----------
    centers_xy : [n_lines, 2] array
        line centre points (x, y) in the projected-grid PIXEL frame
        (column, row).
    angle : float
        flow direction in radians, measured from the +x (column) axis toward
        +row (i.e. image convention, y down).
    length : float
        line length in pixels.
    n_samples : int
        samples per line (static).

    Returns
    -------
    (rows, cols) : [n_lines, n_samples] float32 pixel coordinates.
    """
    centers = np.asarray(centers_xy, dtype=np.float64)
    t = np.linspace(-length / 2.0, length / 2.0, n_samples)
    cols = centers[:, 0:1] + np.cos(angle) * t[None, :]
    rows = centers[:, 1:2] + np.sin(angle) * t[None, :]
    return rows.astype(np.float32), cols.astype(np.float32)


@jax.jit
def build_sti(frames: jnp.ndarray, rows: jnp.ndarray, cols: jnp.ndarray) -> jnp.ndarray:
    """Space-time images: sample each line in every frame (bilinear).

    frames: [T, H, W]; rows/cols: [n_lines, L] pixel coordinates.
    Returns [n_lines, T, L] float32.
    """
    frames = frames.astype(jnp.float32)

    def sample_frame(img):  # -> [n_lines, L]
        return jax.scipy.ndimage.map_coordinates(img, [rows, cols], order=1, mode="nearest")

    sti = jax.vmap(sample_frame)(frames)  # [T, n_lines, L]
    return jnp.moveaxis(sti, 0, 1)


def _box_smooth_1d(x: jnp.ndarray, size: int, axis: int) -> jnp.ndarray:
    """Box filter along one axis (edge padded, static size)."""
    if size <= 1:
        return x
    pad = [(0, 0)] * x.ndim
    lo = size // 2
    hi = size - 1 - lo
    pad[axis] = (lo, hi)
    xp = jnp.pad(x, pad, mode="edge")
    c = jnp.cumsum(xp, axis=axis)
    zero = jnp.zeros_like(jax.lax.slice_in_dim(c, 0, 1, axis=axis))
    c = jnp.concatenate([zero, c], axis=axis)
    n = x.shape[axis]
    top = jax.lax.slice_in_dim(c, size, size + n, axis=axis)
    bot = jax.lax.slice_in_dim(c, 0, n, axis=axis)
    return (top - bot) / size


def _sti_orientation(sti: jnp.ndarray, window: int, valid: Optional[jnp.ndarray] = None):
    """Structure-tensor streak slope m [samples/frame] and coherence.

    Callers must have removed the static background already (see
    :func:`sti_velocity`): subtracting the temporal mean AFTER de-shearing
    would delete the (now near-vertical) signal streaks themselves.

    ``valid`` ([n_lines, T, L] in {0,1}) weights the tensor averaging so
    positions the de-shear resampled from outside the line (edge-clamped,
    pure artifact) contribute nothing; where fewer than half the samples in
    an averaging region are genuine, m is NaN and coherence 0.
    """
    gt = jnp.gradient(sti, axis=-2)
    gx = jnp.gradient(sti, axis=-1)
    w = jnp.ones_like(sti) if valid is None else valid
    jtt = gt * gt * w
    jxx = gx * gx * w
    jtx = gt * gx * w
    if window and window > 0:
        red = lambda a: _box_smooth_1d(jnp.mean(a, axis=-2), int(window), axis=-1)
    else:
        red = lambda a: jnp.mean(a, axis=(-2, -1))
    frac = red(w)
    jtt, jxx, jtx = red(jtt) / jnp.maximum(frac, 1e-6), red(jxx) / jnp.maximum(frac, 1e-6), red(jtx) / jnp.maximum(frac, 1e-6)
    # streak angle: the large-eigenvalue direction of J is the gradient
    # normal; the streak is perpendicular. phi measured from the t axis.
    phi = 0.5 * jnp.arctan2(2.0 * jtx, jtt - jxx) + jnp.pi / 2
    m = jnp.tan(phi)
    trace = jtt + jxx
    ok = (trace > 1e-12) & (frac >= 0.5)
    coherence = jnp.where(
        ok, jnp.sqrt((jtt - jxx) ** 2 + 4.0 * jtx**2) / jnp.maximum(trace, 1e-12), 0.0
    )
    m = jnp.where(ok, m, jnp.nan)
    return m, coherence


def _shear_sti(sti: jnp.ndarray, m: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Resample each STI along x' = x + m * (t - T/2) (bilinear, edge clamp).

    With m equal to the true streak slope the sheared STI's streaks become
    vertical (slope 0), where the gradient-tensor estimator is unbiased.

    Also returns a {0,1} validity mask: positions whose source column fell
    outside the line are edge-clamped copies, not data, and must not feed
    the orientation tensor (they otherwise fabricate steep fake streaks at
    the line ends — the larger |m|, the wider the contaminated margin).
    """
    n_lines, t_len, l_len = sti.shape
    tt = jnp.arange(t_len, dtype=jnp.float32) - (t_len - 1) / 2.0
    xx = jnp.arange(l_len, dtype=jnp.float32)
    rows = jnp.broadcast_to(jnp.arange(t_len, dtype=jnp.float32)[:, None], (t_len, l_len))

    def one(img, mk):
        cols = xx[None, :] + mk * tt[:, None]
        out = jax.scipy.ndimage.map_coordinates(img, [rows, cols], order=1, mode="nearest")
        valid = ((cols >= 0.0) & (cols <= l_len - 1.0)).astype(jnp.float32)
        return out, valid

    return jax.vmap(one)(sti, m)


@functools.partial(jax.jit, static_argnums=(3, 4))
def sti_velocity(
    sti: jnp.ndarray, step_px: float, dt: float, window: int = 0, refine: int = 2
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Velocity (px of the ORIGINAL image per second) from STI streak angles.

    The dominant texture orientation is the small-eigenvalue direction of the
    2x2 gradient structure tensor J = <∇I ∇Iᵀ>, ∇ = (∂t, ∂x); the streak
    slope m = dx/dt [samples/frame] converts to velocity as
    ``v = m * step_px / dt`` (step_px = line sample spacing in image pixels,
    dt = seconds per frame). Positive v points along the +line direction.

    Parameters
    ----------
    sti : [n_lines, T, L]
    step_px, dt : float
        sample spacing (px) and frame interval (s).
    window : int
        if > 0, tensor averaging uses a box of this many samples along the
        line (velocity PROFILE, output [n_lines, L]); if 0, the tensor is
        averaged over the whole STI (one velocity per line, output
        [n_lines]).
    refine : int
        shear-refinement iterations: the finite-difference gradient
        attenuates steep streaks (underestimating |v| beyond ~1.5
        samples/frame), so each iteration de-shears the STI by the current
        estimate and measures the residual slope near vertical, where the
        estimator is unbiased.

    Returns
    -------
    (velocity, coherence): coherence in [0, 1] is the anisotropy of the
    structure tensor — the STIV analogue of a signal-to-noise ratio.
    """
    # remove the static background (per-position temporal mean) ONCE, in the
    # original STI frame, so fixed texture doesn't bias the angle to zero;
    # de-sheared copies are resampled from this background-free image
    sti = sti - jnp.mean(sti, axis=-2, keepdims=True)
    m_total = jnp.zeros(sti.shape[0], dtype=jnp.float32)
    cur, valid = sti, None
    for _ in range(max(int(refine), 0)):
        m_k, _ = _sti_orientation(cur, 0, valid)
        m_total = m_total + jnp.nan_to_num(m_k)
        cur, valid = _shear_sti(sti, m_total)
    m_res, coherence = _sti_orientation(cur, int(window), valid)
    if window and window > 0:
        m = m_total[:, None] + m_res
    else:
        m = m_total + m_res
    v = m * (step_px / dt)
    return v, coherence
