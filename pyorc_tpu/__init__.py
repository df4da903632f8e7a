"""pyorc_tpu — video velocimetry (LSPIV) on the GPU with JAX.

A ground-up JAX/XLA rebuild of the capabilities of pyOpenRiverCam (reference:
localdevices/pyorc): video of a river in, surface velocity fields and
discharge out. Frame preprocessing, orthorectification and FFT-based PIV
cross-correlation run as jitted XLA programs on the device (an NVIDIA GPU);
mask chains and transect reductions, the geometry core (camera model, PnP,
CRS, float64 numpy) and IO (video decode, netCDF, GeoTIFF) run on the host.
"""

__version__ = "0.1.0"

from . import ndx
from .ndx import DataArray, Dataset, open_dataset
from . import api as _api  # registers .frames/.velocimetry/.transect accessors  # noqa: E402

__all__ = [
    "DataArray",
    "Dataset",
    "open_dataset",
    "ndx",
    "Video",
    "CameraConfig",
    "CrossSection",
    "Frames",
    "Velocimetry",
    "Transect",
    "load_camera_config",
    "get_camera_config",
    "project_numpy",
    "project_cv",
    "service",
    "cli",
    "sample_data",
    "plot_helpers",
    "__version__",
]


def __getattr__(name):
    # lazy imports keep `import pyorc_tpu` light and avoid jax import cost for CLI help
    if name in ("Video",):
        from .api.video import Video

        return Video
    if name in ("CameraConfig", "load_camera_config", "get_camera_config"):
        from .api import cameraconfig

        return getattr(cameraconfig, name)
    if name == "CrossSection":
        from .api.cross_section import CrossSection

        return CrossSection
    if name == "Frames":
        from .api.frames import Frames

        return Frames
    if name == "Velocimetry":
        from .api.velocimetry import Velocimetry

        return Velocimetry
    if name == "Transect":
        from .api.transect import Transect

        return Transect
    if name in ("project_numpy", "project_cv"):
        from . import project

        return getattr(project, name)
    if name in ("service", "sample_data", "cli", "project", "plot_helpers"):
        import importlib
        import sys

        mod = importlib.import_module(f"{__name__}.{name}")
        setattr(sys.modules[__name__], name, mod)
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
