"""CLI + service pipeline tests: recipe E2E on the geul video, hash cache,
camera-config command (click.testing.CliRunner, like the reference tests)."""

import json
import os

import numpy as np
import pytest
import yaml
from click.testing import CliRunner

GEUL_MP4 = "/root/reference/examples/geul/dk_control.mp4"
GEUL_CFG = "/root/reference/examples/geul/dk_cam_config.json"

GCPS_SRC = [[158, 314], [418, 245], [655, 162], [948, 98], [1587, 321], [1465, 747]]
GCPS_DST = [
    [192102.50255553858, 313157.5882846481, 150.831],
    [192101.3882378415, 313160.1101843005, 150.717],
    [192099.77023223988, 313163.2868999007, 150.807],
    [192096.8922817797, 313169.2557434712, 150.621],
    [192105.2958125107, 313172.0257530752, 150.616],
    [192110.35620407888, 313162.5371485311, 150.758],
]


@pytest.fixture(scope="module")
def cross_geojson(tmp_path_factory):
    """Synthetic V-shaped cross-section across the geul AOI."""
    import pyorc_tpu

    cc = pyorc_tpu.load_camera_config(GEUL_CFG)
    coords = np.asarray(cc.bbox.exterior.coords)
    p_left = (coords[0] + coords[1]) / 2
    p_right = (coords[2] + coords[3]) / 2
    n = 15
    xs = np.linspace(p_left[0], p_right[0], n)
    ys = np.linspace(p_left[1], p_right[1], n)
    z0 = cc.gcps["z_0"]
    t = np.linspace(-1, 1, n)
    zs = z0 + 0.6 * t**2 - 0.35
    feats = [
        {"type": "Feature", "properties": {}, "geometry": {"type": "Point", "coordinates": [float(x), float(y), float(z)]}}
        for x, y, z in zip(xs, ys, zs)
    ]
    gj = {
        "type": "FeatureCollection",
        "crs": {"type": "name", "properties": {"name": "urn:ogc:def:crs:EPSG::28992"}},
        "features": feats,
    }
    fn = tmp_path_factory.mktemp("cross") / "cross.geojson"
    with open(fn, "w") as f:
        json.dump(gj, f)
    return str(fn)


@pytest.fixture(scope="module")
def recipe_dict(cross_geojson):
    return {
        "video": {"start_frame": 0, "end_frame": 6, "h_a": 92.36},
        # mirrors the reference's shipped recipe shape (ngwerere.yml):
        # normalize -> edge_detect -> minmax. minmax(-5, 5) only makes sense
        # AFTER edge_detect — normalize rescales to uint8 0..255, and
        # clamping that to [0, 5] destroys the correlation signal.
        "frames": {
            "normalize": {"samples": 2},
            "edge_detect": {"wdw_1": 1, "wdw_2": 2},
            "minmax": {"min": -5, "max": 5},
        },
        "velocimetry": {"get_piv": {"window_size": 32}, "write": True},
        "mask": {"write": True, "mask_group1": {"corr": None}},
        "transect": {
            "write": True,
            "transect_1": {
                "shapefile": cross_geojson,
                "get_transect": {"wdw": 1},
                "get_q": {"fill_method": "zeros"},
                "get_river_flow": None,
            },
        },
        # beyond-reference: STIV search lines along the same cross-section
        "stiv": {
            "write": True,
            "stiv_1": {"shapefile": cross_geojson, "length": 2.0, "distance": 1.0},
        },
    }


@pytest.fixture(scope="module")
def service_output(recipe_dict, tmp_path_factory):
    """Run the full service pipeline once for several tests."""
    from pyorc_tpu.cli import cli_utils
    from pyorc_tpu.service import velocity_flow

    out = str(tmp_path_factory.mktemp("service_out"))
    recipe = cli_utils.validate_recipe(json.loads(json.dumps(recipe_dict)))
    camconfig = cli_utils.parse_camconfig(None, None, GEUL_CFG)
    velocity_flow(
        recipe=recipe, videofile=GEUL_MP4, cameraconfig=camconfig, prefix="", output=out, h_a=92.36
    )
    return out


def test_validate_recipe(recipe_dict):
    from pyorc_tpu.cli.cli_utils import validate_recipe

    r = validate_recipe(json.loads(json.dumps(recipe_dict)))
    assert "video" in r and "frames" in r and "velocimetry" in r
    with pytest.raises(ValueError, match="not allowed"):
        validate_recipe({"bogus_section": {}})
    with pytest.raises(ValueError, match="does not have a method"):
        validate_recipe({"frames": {"not_a_method": {}}})


def test_read_shape(cross_geojson):
    from pyorc_tpu.cli.cli_utils import read_shape

    coords, crs = read_shape(fn=cross_geojson)
    assert len(coords) == 15
    assert len(coords[0]) == 3
    assert crs == 28992


def test_service_outputs(service_output):
    import pyorc_tpu

    assert os.path.isfile(os.path.join(service_output, "piv.nc"))
    assert os.path.isfile(os.path.join(service_output, "piv_mask.nc"))
    fn_tr = os.path.join(service_output, "transect_transect_1.nc")
    assert os.path.isfile(fn_tr)
    tr = pyorc_tpu.open_dataset(fn_tr)
    assert "river_flow" in tr
    Q = tr["river_flow"].values
    assert Q.shape == (5,)
    assert np.isfinite(Q).all()
    # the discharge must be NON-trivial: a degenerate transect (no valid
    # velocimetry points over the bathymetry) silently yields all-zero Q
    # with fill_method="zeros", which this guards against
    assert np.nanmax(np.abs(Q)) > 0.01
    assert np.nanmax(np.abs(Q)) < 100.0  # sane magnitude for a small stream
    # most mid-channel transect points carry real velocities
    assert np.isfinite(tr["v_eff_nofill"].values).any(axis=0).mean() > 0.5
    # hash cache written
    cache = os.listdir(os.path.join(service_output, ".pyorc"))
    assert any(f.endswith(".hash") for f in cache)
    assert "velocimetry.yml" in cache


def test_service_stiv_output(service_output):
    """The stiv recipe section produces a netCDF with v + coherence per line."""
    import pyorc_tpu

    fn = os.path.join(service_output, "stiv_stiv_1.nc")
    assert os.path.isfile(fn)
    ds = pyorc_tpu.open_dataset(fn)
    assert "v" in ds and "coherence" in ds
    v = np.asarray(ds["v"].values)
    coh = np.asarray(ds["coherence"].values)
    assert v.ndim == 1 and len(v) >= 3  # one line per `distance` along the section
    assert np.isfinite(coh).all() and (coh >= 0).all() and (coh <= 1).all()
    assert np.isfinite(v).any()  # the stream carries real streak signal


def test_service_update_skips(service_output, recipe_dict, capsys):
    """With update=True and unchanged inputs, velocimetry + mask stages skip."""
    import logging

    from pyorc_tpu.cli import cli_utils
    from pyorc_tpu.service.velocimetry import VelocityFlowProcessor

    recipe = cli_utils.validate_recipe(json.loads(json.dumps(recipe_dict)))
    camconfig = cli_utils.parse_camconfig(None, None, GEUL_CFG)
    logs = []

    class ListLogger(logging.Logger):
        def info(self, msg, *a, **k):
            logs.append(str(msg))

        def debug(self, msg, *a, **k):
            logs.append(str(msg))

        def warning(self, msg, *a, **k):
            logs.append(str(msg))

        def error(self, msg, *a, **k):
            logs.append(str(msg))

    proc = VelocityFlowProcessor(
        recipe=recipe,
        videofile=GEUL_MP4,
        cameraconfig=camconfig,
        prefix="",
        output=service_output,
        h_a=92.36,
        update=True,
        logger=ListLogger("t"),
    )
    proc.process()
    skipped = [m for m in logs if "skipping" in m]
    assert len(skipped) >= 2  # velocimetry + mask


def test_cli_velocimetry_help():
    from pyorc_tpu.cli.main import cli

    runner = CliRunner()
    result = runner.invoke(cli, ["velocimetry", "--help"])
    assert result.exit_code == 0
    assert "--cross_wl" in result.output
    result = runner.invoke(cli, ["--info"])
    assert result.exit_code == 0
    assert "pyorc-tpu" in result.output


def test_cli_camera_config(tmp_path):
    from pyorc_tpu.cli.main import cli

    runner = CliRunner()
    out_json = str(tmp_path / "cam.json")
    result = runner.invoke(
        cli,
        [
            "camera-config",
            "-V", GEUL_MP4,
            "--crs", "28992",
            "--src", json.dumps(GCPS_SRC),
            "--dst", json.dumps(GCPS_DST),
            "--z_0", "150.49",
            "--h_ref", "92.45",
            "--resolution", "0.02",
            "--window_size", "32",
            "--corners", json.dumps([[390, 440], [1060, 160], [1800, 270], [1500, 880]]),
            out_json,
        ],
    )
    assert result.exit_code == 0, result.output
    assert os.path.isfile(out_json)
    import pyorc_tpu

    cc = pyorc_tpu.load_camera_config(out_json)
    # intrinsic fit close to the reference's own fixture fit (f=1750.3, k1=-0.48)
    assert 1500 < cc.camera_matrix[0][0] < 2000
    assert cc.dist_coeffs[0][0] < -0.2
    assert os.path.isfile(out_json.replace(".json", "_geo.jpg"))
    assert os.path.isfile(out_json.replace(".json", "_cam.jpg"))


def test_cli_velocimetry_e2e(recipe_dict, tmp_path):
    """Full CLI command end-to-end."""
    from pyorc_tpu.cli.main import cli

    fn_recipe = tmp_path / "recipe.yml"
    with open(fn_recipe, "w") as f:
        yaml.dump(recipe_dict, f)
    out = str(tmp_path / "out")
    runner = CliRunner()
    result = runner.invoke(
        cli,
        ["velocimetry", "-V", GEUL_MP4, "-c", GEUL_CFG, "-r", str(fn_recipe), "-h", "92.36", out],
    )
    assert result.exit_code == 0, result.output
    assert os.path.isfile(os.path.join(out, "piv.nc"))
    assert os.path.isfile(os.path.join(out, "transect_transect_1.nc"))


def test_subprocess_runner_builds_files(recipe_dict, tmp_path, monkeypatch):
    """velocity_flow_subprocess serializes inputs and shells out (command may
    fail if entry point not installed; files must exist)."""
    from pyorc_tpu.cli import cli_utils
    from pyorc_tpu.service import velocity_flow_subprocess

    # the subprocess runs its own JAX process; keep it on the CPU backend
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    out = str(tmp_path / "sub_out")
    camconfig = cli_utils.parse_camconfig(None, None, GEUL_CFG)
    result = velocity_flow_subprocess(
        videofile=GEUL_MP4,
        recipe=json.loads(json.dumps(recipe_dict)),
        cameraconfig=camconfig,
        output=out,
        h_a=92.36,
    )
    assert os.path.isfile(os.path.join(out, "recipe.yml"))
    assert os.path.isfile(os.path.join(out, "camera_config.json"))
    assert result is not None
    if result.returncode == 0:
        assert os.path.isfile(os.path.join(out, "piv.nc"))


def test_stage_ledger_edge_cases(tmp_path):
    """StageLedger staleness contract, mirroring the reference's hash-cache
    tests (reference tests/test_cli.py:293-430): missing artifact, missing
    digest, content change, recipe-slice change, and the current case."""
    import logging

    from pyorc_tpu.service.velocimetry import StageLedger

    ledger = StageLedger(str(tmp_path), "pfx_", logging)
    recipe = {"video": {"start_frame": 0}, "frames": {"normalize": {}}}
    art = tmp_path / "piv.nc"
    art.write_bytes(b"payload-one")
    keys, files = ("video", "frames"), (str(art),)

    # nothing committed yet -> stale
    assert not ledger.is_current("frames", recipe, keys, files)
    ledger.commit("frames", recipe, keys, files)
    assert ledger.is_current("frames", recipe, keys, files)

    # tracked file content changed -> stale; recommit restores currency
    art.write_bytes(b"payload-two")
    assert not ledger.is_current("frames", recipe, keys, files)
    ledger.commit("frames", recipe, keys, files)
    assert ledger.is_current("frames", recipe, keys, files)

    # recipe slice changed -> stale; unrelated sections don't matter
    changed = {"video": {"start_frame": 5}, "frames": {"normalize": {}}}
    assert not ledger.is_current("frames", changed, keys, files)
    unrelated = dict(recipe, mask=[{"corr": {}}])
    assert ledger.is_current("frames", unrelated, keys, files)

    # tracked file deleted -> stale
    art.unlink()
    assert not ledger.is_current("frames", recipe, keys, files)
