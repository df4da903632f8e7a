"""Frame preprocessing filters as fused XLA ops.

Device-side replacements for the reference's per-frame dask/OpenCV filters
(reference ``pyorc/api/frames.py:279-467`` + ``pyorc/cv.py:142-183``): all
operate on [T, H, W] float32 batches in one jit each, so XLA fuses the
elementwise chains and the separable Gaussian convolutions run on the device
instead of per-frame host calls. The convolutions stay float32 on a GPU: an
H100 gives the float64 result to float32 rounding (3e-5 on 0-255 pixels), so
no TF32 path is taken.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "gaussian_kernel_cv",
    "gaussian_blur",
    "edge_detect",
    "normalize_with_mean",
    "time_diff",
    "minmax",
    "frame_range",
    "reduce_rolling",
]


def gaussian_kernel_cv(ksize: int) -> np.ndarray:
    """1-D Gaussian kernel identical to OpenCV's getGaussianKernel(ksize, 0).

    OpenCV uses fixed binomial kernels for ksize <= 7 with sigma<=0, else
    sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8.
    """
    fixed = {
        1: [1.0],
        3: [0.25, 0.5, 0.25],
        5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
        7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    }
    if ksize in fixed:
        return np.asarray(fixed[ksize], dtype=np.float32)
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    k = k / k.sum()
    # OpenCV uses a bit-exact kernel quantized to multiples of 1/256, with the
    # rounding residual folded into the centre tap — replicate for parity
    q = np.round(k * 256)
    q[ksize // 2] -= q.sum() - 256
    return (q / 256).astype(np.float32)


def _sep_conv(frames: jnp.ndarray, kernel: np.ndarray) -> jnp.ndarray:
    """Separable 2-D convolution with REFLECT_101 borders on [T, H, W]."""
    k = jnp.asarray(kernel, dtype=jnp.float32)
    pad = len(kernel) // 2
    if pad == 0:
        return frames
    x = jnp.pad(frames, ((0, 0), (pad, pad), (pad, pad)), mode="reflect")
    # convolve rows then cols via conv_general_dilated on a length-1 channel
    t, h, w = x.shape
    lhs = x.reshape(t, 1, h, w)
    kv = k.reshape(1, 1, -1, 1)
    kh = k.reshape(1, 1, 1, -1)
    dn = jax.lax.conv_dimension_numbers(lhs.shape, kv.shape, ("NCHW", "OIHW", "NCHW"))
    out = jax.lax.conv_general_dilated(lhs, kv, (1, 1), "VALID", dimension_numbers=dn)
    out = jax.lax.conv_general_dilated(out, kh, (1, 1), "VALID", dimension_numbers=dn)
    return out.reshape(t, h - 2 * pad, w - 2 * pad)


@functools.partial(jax.jit, static_argnums=(1,))
def gaussian_blur(frames, ksize: int):
    """cv2.GaussianBlur-equivalent smooth (reference pyorc/cv.py:142-159)."""
    return _sep_conv(frames.astype(jnp.float32), gaussian_kernel_cv(ksize))


@functools.partial(jax.jit, static_argnums=(1, 2))
def edge_detect(frames, ksize_1: int, ksize_2: int):
    """Difference-of-Gaussians band filter (reference pyorc/cv.py:162-183)."""
    f = frames.astype(jnp.float32)
    blur1 = _sep_conv(f, gaussian_kernel_cv(ksize_1))
    blur2 = _sep_conv(f, gaussian_kernel_cv(ksize_2))
    return blur2 - blur1


@jax.jit
def normalize_with_mean(frames, mean):
    """Subtract temporal mean, rescale each frame to [0, 255] uint8.

    Core of Frames.normalize (reference pyorc/api/frames.py:279-306); the
    sampled temporal mean is computed by the caller (possibly streamed).
    """
    reduce = frames.astype(jnp.float32) - mean
    fmin = reduce.min(axis=(-2, -1), keepdims=True)
    fmax = reduce.max(axis=(-2, -1), keepdims=True)
    return ((reduce - fmin) / (fmax - fmin) * 255).astype(jnp.uint8)


@jax.jit
def normalize_with_stats(frames, mean, fmin, fmax):
    """``normalize_with_mean`` with the per-frame min/max supplied.

    Used by the upload-crop path in Frames.project: the rescale extrema are a
    GLOBAL per-frame reduction, so on cropped frames they must come from the
    full frame — computed bit-exactly on the host (subtract and min/max are
    exact, order-independent float32 ops) before the crop discards pixels.
    """
    reduce = frames.astype(jnp.float32) - mean
    return ((reduce - fmin) / (fmax - fmin) * 255).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnums=(1, 2))
def time_diff(frames, thres: float = 0.0, abs: bool = False):
    """Temporal differencing (reference pyorc/api/frames.py:409-436)."""
    d = jnp.diff(frames.astype(jnp.float32), axis=0)
    d = jnp.where(d > thres, d, 0.0)
    return jnp.abs(d) if abs else d


@functools.partial(jax.jit, static_argnums=(1, 2))
def minmax(frames, min: float = -np.inf, max: float = np.inf):
    return jnp.maximum(jnp.minimum(frames, max), min)


@jax.jit
def frame_range(frames):
    """Temporal min-max range per pixel (reference pyorc/api/frames.py:364-379)."""
    return frames.max(axis=0) - frames.min(axis=0)


@functools.partial(jax.jit, static_argnums=(1,))
def reduce_rolling(frames, samples: int):
    """Remove rolling temporal mean (reference pyorc/api/frames.py:381-407).

    The rolling window is trailing with min_periods == samples (xarray
    default), so the first samples-1 frames have undefined rolling mean; the
    reference's ``where(roll_mean != 0, 0)`` + uint8 cast zeroes them.
    """
    f = frames.astype(jnp.float32)
    csum = jnp.cumsum(f, axis=0)
    roll_sum = csum - jnp.concatenate([jnp.zeros_like(csum[:samples]), csum[:-samples]], axis=0)
    roll_mean = roll_sum / samples
    t = f.shape[0]
    valid = (jnp.arange(t) >= samples - 1)[:, None, None]
    reduce = f - roll_mean
    thres = jnp.maximum(reduce, 0.0)
    denom = thres.max(axis=(-2, -1), keepdims=True)
    norm = thres * 255 / jnp.maximum(denom, 1e-10)
    norm = jnp.where(valid & (roll_mean != 0), norm, 0.0)
    return norm.astype(jnp.uint8)
