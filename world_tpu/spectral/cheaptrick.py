"""CheapTrick spectral-envelope estimation — fully batched over frames.

Semantics follow /root/reference/world/cheaptrick.py (per-frame F0-adaptive
window -> power spectrum + DC mirror fill -> rectangular smoothing ->
cepstral liftering), but the execution model is batch-first: every frame is a
row of a fixed-shape batch; the whole utterance is ONE windowed-gather, ONE
batched rFFT, ONE cumsum-smoothing and ONE batched cepstrum round-trip.
Divergences from the reference (documented):
  * the random eps guard (cheaptrick.py:117) is a deterministic eps;
  * inputs are immutable — the reference mutates source['f0'] in place
    (cheaptrick.py:27,33); here the effective f0 is computed functionally.
"""
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..dsp.interp import interp1h_uniform
from ..dsp.minphase import mirror_full
from ..frames import (apply_adaptive_window, uniform_frame_period_ms,
                      windowed_segment_batch)


_EPS64 = 2.220446049250313e-16   # np.finfo(np.float64).eps
_FRAME_BLOCK = 32


def default_fft_size(fs: int) -> int:
    return int(2 ** math.ceil(math.log2(3 * fs / 71 + 1)))


def _uniform_extrap_interp(y, x0, dx, m, xq, n_static: int):
    """Linear interp on the uniform ascending grid x0 + k*dx (k < m, padded to
    n_static) with linear extrapolation at both ends (scipy
    fill_value='extrapolate' on a uniform grid)."""
    pos = (xq - x0) / dx
    base = jnp.clip(jnp.floor(pos), 0, m - 2)
    frac = pos - base
    b = base.astype(jnp.int32)
    y0 = jnp.take(y, b)
    y1 = jnp.take(y, jnp.minimum(b + 1, n_static - 1))
    return y0 + (y1 - y0) * frac


def _power_spectrum_with_dc_fill(waveform_padded, shift, fs, fft_size, f0, dtype):
    """|FFT|^2 with the low-frequency mirror fill (cheaptrick.py:64-75).

    Batched: waveform_padded (F, L) zero-padded segments whose true windows
    start at ``shift`` (F,) (the reference fft's its length-(2*half+1)
    waveform directly, so the window must sit at position 0).
    Returns (half_power (F, fft//2+1), ps_spectrum (F, fft) complex).
    """
    from ..dsp.scanops import take_rows

    F, L = waveform_padded.shape
    # the window occupies [shift, shift+2*half] of the padded slab and must
    # sit at position 0 for the fft; a circular left-shift by `shift` does
    # that exactly (nothing nonzero wraps), and in the spectrum it is just a
    # phase ramp — power needs NO shift at all
    spec0 = jnp.fft.fft(waveform_padded[:, :fft_size], fft_size)
    k_idx = jnp.arange(fft_size, dtype=dtype)[None, :]
    ramp = jnp.exp((2j * jnp.pi / fft_size) * shift[:, None].astype(dtype) * k_idx)
    ps_spectrum = spec0 * ramp
    power_half = jnp.abs(spec0[:, : fft_size // 2 + 1]) ** 2

    from ..dsp.dcfill import dc_fill_add

    # bins with frequency < f0 + df get a mirrored replica added (gather-free)
    power_filled = dc_fill_add(power_half, f0, fs, fft_size,
                               boundary_factor=1.0, KL=128, dtype=dtype)
    return power_filled, ps_spectrum


def _linear_smoothing(power_full, f0, fs, fft_size: int, dtype):
    """Rectangular smoothing of width 2*f0/3 (cheaptrick.py:103-118), via the
    FFT row-shift cumsum difference (see aperiodicity.common.rect_smooth_half)."""
    from ..aperiodicity.common import rect_smooth_half

    smoothed = rect_smooth_half(power_full, (2.0 / 3.0) * f0[:, 0], fs,
                                fft_size, dtype)
    # the reference adds float64 eps (cheaptrick.py:117) whatever the data's
    # dtype: an absolute float32 eps (1.2e-7) would swamp every bin ~50 dB
    # below a speech frame's peak.  The scale-relative floor guards a
    # rounding dip below zero on dead bins (inactive in f64)
    eps = jnp.finfo(power_full.dtype).eps
    floor = jnp.mean(power_full, axis=-1, keepdims=True) * eps * eps
    return jnp.maximum(smoothed + _EPS64, floor)


def _smoothing_with_recovery(smoothed_full, f0, fs, fft_size: int, q1, dtype):
    """Cepstral liftering (cheaptrick.py:136-157), vectorized over frames."""
    q = jnp.arange(fft_size, dtype=dtype) / fs
    sl = jnp.where(q == 0, 1.0,
                   jnp.sin(jnp.pi * f0[:, None] * q) / (jnp.pi * f0[:, None] * q + (q == 0)))
    cl = (1 - 2 * q1) + 2 * q1 * jnp.cos(2 * jnp.pi * q * f0[:, None])
    # mirror symmetry: entries [fft//2+1:] = entries [fft//2-1:0:-1]
    idx = np.arange(fft_size)
    sym = np.where(idx > fft_size // 2, fft_size - idx, idx)
    sl = sl[:, sym]
    cl = cl[:, sym]
    cep = jnp.fft.fft(jnp.log(smoothed_full))
    env = jnp.exp(jnp.fft.ifft(cep * sl * cl).real)
    return env[:, : fft_size // 2 + 1]


@partial(jax.jit, static_argnames=("fs", "fft_size", "q1", "frame_period_ms"))
def _cheaptrick_core(x, fs, f0_seq, temporal_positions, fft_size, q1,
                     frame_period_ms=None):
    dtype = x.dtype
    f0_low_limit = fs * 3.0 / (fft_size - 3.0)
    default_f0 = 500.0
    # frames are independent: pad their count to a multiple of _FRAME_BLOCK
    # so a frame's batched FFT sees the same neighbours whether the program
    # runs one utterance or a vmapped batch (the CPU FFT groups transforms
    # in blocks and rounds a transform differently by its place in a block)
    n_frames = f0_seq.shape[0]
    pad = (-n_frames) % _FRAME_BLOCK
    f0_seq = jnp.pad(f0_seq, (0, pad), constant_values=default_f0)
    temporal_positions = jnp.pad(temporal_positions, (0, pad), mode="edge")
    f0_eff = jnp.where(f0_seq < f0_low_limit, default_f0, f0_seq)

    max_half = (fft_size - 2) // 2  # half <= int(1.5*fs/f0_low_limit+.5) <= this

    from ..aperiodicity.common import frame_segments

    seg = frame_segments(x, float(fs), temporal_positions, max_half,
                         frame_period_ms)
    waveform, _, _ = apply_adaptive_window(
        seg, float(fs), f0_eff, temporal_positions, 1.5, max_half, "hanning",
        sub_sample_shift=False, normalize_window=True)
    half = jnp.floor(1.5 * fs / f0_eff + 0.5).astype(jnp.int32)
    shift = max_half - half
    power_half, ps_spec = _power_spectrum_with_dc_fill(
        waveform, shift, float(fs), fft_size, f0_eff, dtype)
    power_full = mirror_full(power_half)
    smoothed = _linear_smoothing(power_full, f0_eff[:, None], float(fs), fft_size, dtype)
    smoothed_full = mirror_full(smoothed)
    env = _smoothing_with_recovery(smoothed_full, f0_eff, float(fs), fft_size, q1, dtype)
    return env[:n_frames], ps_spec[:n_frames], f0_eff[:n_frames]


def cheaptrick(x, fs, source_object, q1=-0.15, fft_size=None):
    """Spectral envelope estimation (API mirrors cheaptrick.py:9-39).

    Returns spectrogram (fft//2+1, n_frames) frequency-major like the
    reference, plus the complex pitch-synchronous spectrogram.  Does NOT
    mutate ``source_object``; the mutated-f0 contour the reference would
    produce is returned as 'f0_effective'.
    """
    x = jnp.asarray(x)
    if fft_size is None:
        fft_size = default_fft_size(fs)
    f0 = jnp.asarray(source_object["f0"])
    vuv = jnp.asarray(source_object["vuv"])
    f0 = jnp.where(vuv == 0, 500.0, f0)
    tp = jnp.asarray(source_object["temporal_positions"])
    fp_ms = uniform_frame_period_ms(source_object["temporal_positions"])
    env, ps_spec, f0_eff = _cheaptrick_core(x, int(fs), f0, tp, int(fft_size),
                                            float(q1), fp_ms)
    return {
        "temporal_positions": source_object["temporal_positions"],
        "spectrogram": env.T,
        "fs": fs,
        "ps spectrogram": ps_spec.T,
        "f0_effective": f0_eff,
    }
