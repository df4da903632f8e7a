"""The XLA PIV path against the float64 NumPy reference, the correlation
route, and the precision of the matmul-DFT."""

import jax
import numpy as np
import pytest

import chip_smoke
from pyorc_tpu.ops import piv, piv_reference, windows

PLANE_TOL = 1e-4  # planes are in [0, 1]; float32 FFT error is ~1e-6
PX_TOL = 0.01
CONFIDENT_GAP = 5e-3


@pytest.fixture(scope="module")
def frames():
    return chip_smoke.particle_pair(np.random.default_rng(11), 136, 192, 5, (2.3, -1.4))


@pytest.mark.parametrize("method", ["fft", "matmul"])
@pytest.mark.parametrize("ws", [16, 26, 32, 64])
def test_pairs_match_float64_reference(frames, ws, method):
    h, w = frames.shape[1:]
    sas, ov = (ws, ws), (ws // 2, ws // 2)
    n_rows, n_cols = windows.get_field_shape((h, w), sas, ov)
    ref = piv_reference.corr_planes(frames[0], frames[1], ws, ws // 2)
    _, _, planes = piv.cross_corr(frames[:2], sas, ov, corr_method=method)
    assert np.abs(np.asarray(planes)[0].reshape(ref.shape) - ref).max() <= PLANE_TOL
    u, v, _, _ = piv.piv_pairs_strips(frames[:2], (h, w), sas, ov, n_rows, n_cols, None, method)
    u_ref, v_ref = piv_reference.displacement(ref)
    confident = piv_reference.peak_gap(ref) > CONFIDENT_GAP
    assert confident.mean() > 0.9
    assert np.abs(np.asarray(u)[0] - u_ref)[confident].max() <= PX_TOL
    assert np.abs(np.asarray(v)[0] - v_ref)[confident].max() <= PX_TOL


@pytest.mark.parametrize("ws", [16, 26, 32, 64])
def test_ensemble_scan_matches_reference(frames, ws):
    h, w = frames.shape[1:]
    sas, ov = (ws, ws), (ws // 2, ws // 2)
    n_rows, n_cols = windows.get_field_shape((h, w), sas, ov)
    cs_ref, cnt_ref, _, _ = piv_reference.ensemble(frames, ws, ws // 2, corr_min=0.1, s2n_min=1.5)
    cs, cnt, _, _ = piv.piv_ensemble_scan(frames, (h, w), sas, ov, n_rows, n_cols, corr_min=0.1, s2n_min=1.5)
    assert np.array_equal(np.asarray(cnt).reshape(n_rows, n_cols), cnt_ref)
    assert np.abs(np.asarray(cs).reshape(cs_ref.shape) - cs_ref).max() <= PLANE_TOL * (len(frames) - 1)


def test_corr_route_cpu():
    assert jax.default_backend() == "cpu"
    assert piv.corr_route() == "fft"


def test_corr_route_gpu(monkeypatch):
    monkeypatch.setattr(piv.jax, "default_backend", lambda: "gpu")
    assert piv.corr_route() == piv._CORR_METHODS["gpu"]
    assert piv.corr_route("matmul") == "matmul"


def test_corr_route_unknown_platform_raises(monkeypatch):
    monkeypatch.setattr(piv.jax, "default_backend", lambda: "tpu")
    with pytest.raises(RuntimeError, match="unsupported JAX backend 'tpu'"):
        piv.corr_route()
    with pytest.raises(RuntimeError):
        piv.corr_route("fft")


def test_corr_route_explicit_method_wins():
    assert piv.corr_route("matmul") == "matmul"
    assert piv.corr_route("fft") == "fft"
    with pytest.raises(ValueError):
        piv.corr_route("dft")


def test_matmul_dft_runs_at_highest_precision():
    a = np.zeros((3, 16, 16), np.float32)
    jaxpr = jax.make_jaxpr(piv._corr_raw_matmul)(a, a)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 18  # 6 per forward 2-D DFT, 6 for the inverse
    for e in dots:
        assert e.params["precision"] == (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def test_chip_smoke_refuses_cpu():
    with pytest.raises(SystemExit) as err:
        chip_smoke.require_gpu()
    assert err.value.code not in (0, None)


def test_chip_smoke_reference_comparison_small():
    worst = chip_smoke.compare_reference(h=96, w=128, windows=(16, 26, 32), n_ens=4, ens_window=26)
    assert set(worst) >= {"pair 16px fft", "pair 32px matmul", "ensemble 26px fft"}


@pytest.mark.gpu
def test_gpu_matches_reference(frames):
    """On the card: both correlation methods meet the reference at 26 px."""
    for method in ("fft", "matmul"):
        test_pairs_match_float64_reference(frames, 26, method)
