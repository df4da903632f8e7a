"""Device compute kernels: PIV FFT correlation, orthorectification, frame filters."""

from .. import _compile_cache  # noqa: F401  (places the compile cache before the first compile)
from . import piv, windows

__all__ = ["piv", "windows"]
