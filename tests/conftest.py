"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Sharding tests run against XLA's host-platform device virtualization; no
accelerator is needed.
"""

import os
import sys

# chip_smoke.py and bench.py live at the repository root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# tests run on a virtual 8-device CPU mesh unless the run asks for the card
# alone (JAX_PLATFORMS=cuda, for the `gpu`-marked tests)
if os.environ.get("JAX_PLATFORMS") != "cuda":
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# each test worker compiles for itself: writing CPU programs to the persistent
# cache would only cost serialization time
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REF = "/root/reference"
NGWERERE = os.path.join(REF, "examples", "ngwerere")
GEUL = os.path.join(REF, "examples", "geul")
CALIB = os.path.join(REF, "examples", "camera_calib")


@pytest.fixture(scope="session")
def ngwerere_cam_config_json():
    import json

    with open(os.path.join(NGWERERE, "ngwerere.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="session")
def ngwerere_piv_ref():
    """Reference PIV output dataset (golden values from the CPU reference)."""
    from pyorc_tpu import open_dataset

    return open_dataset(os.path.join(NGWERERE, "ngwerere_piv.nc"))


@pytest.fixture(scope="session")
def ngwerere_masked_ref():
    from pyorc_tpu import open_dataset

    return open_dataset(os.path.join(NGWERERE, "ngwerere_masked.nc"))


@pytest.fixture(scope="session")
def geul_video_path():
    return os.path.join(GEUL, "dk_control.mp4")


@pytest.fixture(scope="session")
def geul_cam_config_json():
    import json

    with open(os.path.join(GEUL, "dk_cam_config.json")) as fh:
        return json.load(fh)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX's first device is a GPU (decided
    here, at run time, never while the test module is imported)."""
    if request.node.get_closest_marker("gpu") and jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; JAX found none")
