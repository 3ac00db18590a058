"""Unit tests for the L0 DSP primitives against scipy/numpy ground truth."""
import numpy as np
import pytest
import scipy.signal as ss
from scipy.interpolate import interp1d

import jax.numpy as jnp

from world_tpu import dsp

pytestmark = pytest.mark.smoke


def test_round_matlab():
    x = np.array([-2.5, -1.5, -0.5, -0.4, 0.0, 0.4, 0.5, 1.5, 2.5, 3.49999])
    # reference behavior: (x +/- 0.5) then trunc
    ref = np.trunc(np.where(x > 0, x + 0.5, x - 0.5))
    got = np.asarray(dsp.round_matlab(x))
    np.testing.assert_array_equal(got, ref)


def test_nuttall_matches_reference_formula():
    import math

    for n in [19, 84, 557]:
        t = np.arange(n) * 2 * math.pi / (n - 1)
        coefs = np.array([0.355768, -0.487396, 0.144232, -0.012604])
        ref = coefs @ np.cos(np.arange(4)[:, None] * t[None, :])
        got = np.asarray(dsp.nuttall(n))
        np.testing.assert_allclose(got, ref, atol=1e-12)
        # masked variant with padding
        got_m = np.asarray(dsp.nuttall_masked(n, n + 13))
        np.testing.assert_allclose(got_m[:n], ref, atol=1e-12)
        assert np.all(got_m[n:] == 0)


def test_hanning_matlab():
    ref = ss.windows.hann(130)[1:-1]
    got = np.asarray(dsp.hanning_matlab(128))
    np.testing.assert_allclose(got, ref, atol=1e-12)


def test_interp1_extrap_matches_scipy():
    rng = np.random.RandomState(0)
    xp = np.sort(rng.rand(40)) * 10
    fp = rng.randn(40)
    xq = np.r_[rng.rand(100) * 12 - 1, xp[5], xp[0], xp[-1]]
    ref = interp1d(xp, fp, fill_value="extrapolate")(xq)
    got = np.asarray(dsp.interp1_extrap(xp, fp, xq))
    np.testing.assert_allclose(got, ref, atol=1e-10)


def test_interp1_extrap_masked():
    xp = np.array([0.0, 1.0, 2.0, 3.0, 99.0, 98.0])  # last two are padding
    fp = np.array([0.0, 10.0, 5.0, -5.0, 0.0, 0.0])
    xq = np.array([-0.5, 0.5, 2.5, 3.5])
    ref = interp1d(xp[:4], fp[:4], fill_value="extrapolate")(xq)
    got = np.asarray(dsp.interp1_extrap(xp, fp, xq, valid_count=4))
    np.testing.assert_allclose(got, ref, atol=1e-10)


def test_interp1h_uniform_matches_reference():
    # replicate cheaptrick.interp1H semantics
    def interp1H(x, y, xi):
        delta_x = x[1] - x[0]
        xi = np.maximum(x[0], np.minimum(x[-1], xi))
        xi_base = np.floor((xi - x[0]) / delta_x)
        xi_fraction = (xi - x[0]) / delta_x - xi_base
        delta_y = np.empty_like(y)
        delta_y[:-1] = np.diff(y)
        delta_y[-1] = 0
        return y[xi_base.astype(int)] + delta_y[xi_base.astype(int)] * xi_fraction

    rng = np.random.RandomState(1)
    n = 64
    x0, dx = -3.0, 0.25
    x = x0 + np.arange(n) * dx
    y = rng.randn(n)
    xi = rng.rand(200) * 20 - 5
    ref = interp1H(x, y, xi)
    got = np.asarray(dsp.interp1h_uniform(x0, dx, y, xi, x[-1]))
    np.testing.assert_allclose(got, ref, atol=1e-12)


def test_lfilter_matches_scipy():
    rng = np.random.RandomState(2)
    x = rng.randn(500)
    b = np.array([0.0078202080334971724, 0.015640416066994345, 0.0078202080334971724])
    a = np.array([1.0, -1.7347257688092754, 0.76600660094326412])
    ref = ss.lfilter(b, a, x)
    got = np.asarray(dsp.lfilter(b, a, x))
    np.testing.assert_allclose(got, ref, atol=1e-10)
    # batched
    xb = rng.randn(3, 200)
    refb = ss.lfilter(b, a, xb, axis=-1)
    gotb = np.asarray(dsp.lfilter(b, a, xb))
    np.testing.assert_allclose(gotb, refb, atol=1e-10)


def test_lfilter_with_zi():
    rng = np.random.RandomState(3)
    x = rng.randn(300)
    b, a = ss.cheby1(3, 0.05, 0.8 / 3)
    zi = ss.lfilter_zi(b, a) * x[0]
    ref, _ = ss.lfilter(b, a, x, zi=zi)
    got = np.asarray(dsp.lfilter(b, a, x, zi=jnp.asarray(zi)))
    np.testing.assert_allclose(got, ref, atol=1e-10)


def test_filtfilt_matches_scipy():
    rng = np.random.RandomState(4)
    x = rng.randn(400)
    b, a = ss.cheby1(3, 0.05, 0.8 / 3)
    padlen = 3 * (max(len(a), len(b)) - 1)
    ref = ss.filtfilt(b, a, x, padlen=padlen)
    got = np.asarray(dsp.filtfilt(b, a, x, padlen))
    np.testing.assert_allclose(got, ref, atol=1e-9)


def test_decimate_matlab_matches_reference():
    import sys
    sys.path.insert(0, "/root/repo/tests")
    import ref_shim
    w = ref_shim.reference_world()
    from world import harvest as H

    rng = np.random.RandomState(5)
    x = rng.randn(3000)
    ref = H.decimate_matlab(x, 3, n=3)
    got = np.asarray(dsp.decimate_matlab(x, 3))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-9)


def test_decimate_world_matches_reference(mwm):
    import sys
    sys.path.insert(0, "/root/repo/tests")
    import ref_shim
    ref_shim.reference_world()
    from world import dio as D

    fs, x = mwm
    ref = D.decimate(x, 5)
    got = np.asarray(dsp.decimate_world(x, 5))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-9)


def test_zero_crossing_events_matches_reference():
    import sys
    sys.path.insert(0, "/root/repo/tests")
    import ref_shim
    ref_shim.reference_world()
    from world import dio as D

    rng = np.random.RandomState(6)
    x = np.sin(np.linspace(0, 200, 5000)) + 0.3 * rng.randn(5000)
    fs = 4000.0
    ref_loc, ref_f0 = D.ZeroCrossingEngine(x, fs)
    ev = dsp.zero_crossing_events(jnp.asarray(x), fs, capacity=4000)
    cnt = int(ev.count)
    assert cnt == len(ref_loc)
    np.testing.assert_allclose(np.asarray(ev.locations[:cnt]), ref_loc, atol=1e-10)
    np.testing.assert_allclose(np.asarray(ev.f0[:cnt]), ref_f0, atol=1e-8)


def test_minimum_phase_matches_reference_construction():
    rng = np.random.RandomState(7)
    fft_size = 64
    half = np.abs(rng.randn(fft_size // 2 + 1)) + 0.1
    full = np.r_[half, half[-2:0:-1]]
    # reference construction (synthesis.py:104-115)
    tmp_cepstrum = np.fft.fft(np.log(np.abs(full)) / 2).real
    latter = np.arange(fft_size // 2 + 1, fft_size + 1)
    cc = np.zeros(fft_size)
    cc[latter - 1] = tmp_cepstrum[latter - 1] * 2
    cc[0] = tmp_cepstrum[0]
    ref_spec = np.exp(np.fft.ifft(cc))
    ref_resp = np.fft.fftshift(np.fft.ifft(ref_spec).real)

    full_j = jnp.asarray(dsp.mirror_full(jnp.asarray(half)))
    np.testing.assert_allclose(np.asarray(full_j), full, atol=1e-12)
    got_spec = np.asarray(dsp.minimum_phase_spectrum(full_j))
    np.testing.assert_allclose(got_spec, ref_spec, atol=1e-10)
    got_resp = np.asarray(dsp.minimum_phase_response(full_j))
    np.testing.assert_allclose(got_resp, ref_resp, atol=1e-10)



def test_compensated_cumsum_keeps_window_precision():
    """Windowed sums taken from the compensated float32 prefix sum stay
    accurate relative to the window, 80 dB below the running total; a plain
    float32 cumsum loses them entirely."""
    from world_tpu.dsp.scanops import compensated_cumsum

    rng = np.random.RandomState(0)
    x64 = 10.0 ** (-6 - 2 * rng.rand(4, 2048))    # 60-80 dB below ...
    x64[:, :16] = 1.0                              # ... a loud head
    x = jnp.asarray(x64, jnp.float32)
    hi, lo = compensated_cumsum(x)
    exact = np.cumsum(np.asarray(x, np.float64), axis=-1)
    a, b = 1500, 1540                              # a quiet window
    want = exact[:, b] - exact[:, a]
    got = ((np.asarray(hi[:, b], np.float64) - np.asarray(hi[:, a]))
           + (np.asarray(lo[:, b], np.float64) - np.asarray(lo[:, a])))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    plain = np.cumsum(np.asarray(x), axis=-1)
    assert np.max(np.abs((plain[:, b] - plain[:, a]) - want) / want) > 1e-2


def test_rect_smooth_float32_matches_float64_on_weak_bins():
    """CheapTrick/D4C rectangular smoothing in float32 must track float64 on
    bins ~80 dB below a frame's peak (the float64 goldens resolve them)."""
    from world_tpu.aperiodicity.common import rect_smooth_half

    rng = np.random.RandomState(1)
    fft_size, fs = 1024, 16000.0
    half = 10.0 ** (-8 * np.linspace(0, 1, fft_size // 2 + 1)) * (
        1 + 0.5 * rng.rand(3, fft_size // 2 + 1))
    full = np.concatenate([half, half[:, -2:0:-1]], axis=1)
    width = np.array([80.0, 133.0, 400.0])
    out = {}
    for dt in (jnp.float32, jnp.float64):
        out[dt] = np.asarray(rect_smooth_half(jnp.asarray(full, dt),
                                              jnp.asarray(width, dt), fs,
                                              fft_size, dt), np.float64)
    rel = np.abs(out[jnp.float32] - out[jnp.float64]) / out[jnp.float64]
    assert rel.max() < 1e-4, rel.max()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_uniform_frame_period_detected_in_both_dtypes(dtype):
    """A 5 ms grid is uniform whether it arrives in float64 or float32 (the
    first float32 step is 4.99999988 ms); a warped grid is not."""
    from world_tpu.frames import uniform_frame_period_ms

    tp = (np.arange(929) * 5 / 1000).astype(dtype)
    assert uniform_frame_period_ms(tp) == 5.0
    warped = tp.copy()
    warped[400:] += dtype(0.001)
    assert uniform_frame_period_ms(warped) is None


def test_event_interp_float32_keeps_precision_late_in_long_signals():
    """Zero-crossing interval f0s 35 s into an 8 kHz signal must be as
    accurate in float32 as at its start: positions are taken relative to
    each query, not as absolute float32 sample positions."""
    from world_tpu.f0.events import batched_interval_interp

    fs, n = 8000.0, 8000 * 36
    t = np.arange(n) / fs
    f_true = 150.0 + 30.0 * np.sin(2 * np.pi * 0.3 * t)
    x = np.sin(2 * np.pi * np.cumsum(f_true) / fs)[None, :]
    q = np.arange(35000, 35800)                   # frames at 35-35.8 s
    tq = q / 1000.0
    out = {}
    for dt in (jnp.float32, jnp.float64):
        f0, _ = batched_interval_interp(jnp.asarray(x, dt),
                                        fs, jnp.asarray(np.arange(36000) / 1000.0, dt),
                                        fs * 0.001)
        out[dt] = np.asarray(f0, np.float64)[0, q]
    rel = np.abs(out[jnp.float32] - out[jnp.float64]) / out[jnp.float64]
    assert rel.max() < 2e-5, rel.max()
    assert np.abs(out[jnp.float64] - np.interp(tq, t, f_true)).max() < 2.0
