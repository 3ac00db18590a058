"""Shared D4C machinery (classic + Requiem), explicitly batched over frames.

Semantics from /root/reference/world/d4c.py / d4cRequiem.py; execution is
batch-first: every stage takes (F, ...) arrays so that signal
gathers lower to flat 1-D-operand gathers, row lookups use take_rows, and
spectral smoothing uses a compensated prefix sum (vmapped per-frame code
hides the batch from XLA and falls onto slow gather/scan lowerings).

Key reformulation notes:
  * The centroid spectrum -Im(W)Re(S)+Im(S)Re(W) with W=FFT(-x*t*1j) equals
    Re(conj(S)·U) with U=FFT(x*t) — two real FFTs, and invariant to the
    zero-pad shift of our fixed slabs provided t uses the true 1-based
    in-window position (t = base_index + half + 1).
  * dc_correction / linear_smoothing run on half spectra and mirror at the
    end (they are even-symmetric by construction).
  * get_coarse_aperiodicity's sorted-cumsum ratio equals
    (total - sum_of_(boundary+1)_largest)/total -> top_k, no sort.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..dsp.minphase import mirror_full
from ..dsp.scanops import compensated_cumsum, shift_select_rows, take_rows
from ..dsp.windows import np_nuttall
from ..frames import (apply_adaptive_window, uniform_centered_slabs,
                      windowed_segment_batch)


def frame_segments(x, fs, temporal_positions, max_half: int,
                   frame_period_ms, margin: int = 0):
    """Per-frame signal slabs (F, 2*(max_half+margin)+1) around the
    reference's anchors.  Uniform frame grids take the gather-free strided
    path; arbitrary grids fall back to a flat gather."""
    if frame_period_ms is not None:
        return uniform_centered_slabs(x, float(fs), frame_period_ms / 1000.0,
                                      temporal_positions.shape[0],
                                      temporal_positions, max_half + margin)
    center = jnp.floor(temporal_positions[:, None] * fs + 0.501) + 1.0
    base = jnp.arange(-max_half - margin, max_half + margin + 1,
                      dtype=x.dtype)[None, :]
    safe = jnp.clip(center + base, 1, x.shape[0]).astype(jnp.int32)
    return jnp.take(x, safe - 1)


def d4c_fft_size(fs: int) -> int:
    return int(2 ** np.ceil(np.log2(4 * fs / 47 + 1)))


def love_train_fft_size(fs: int) -> int:
    return int(2 ** np.ceil(np.log2(3 * fs / 40 + 1)))


def dc_correction_half(signal_half, f0, fs, fft_size: int, dtype):
    """Low-frequency mirror fill (d4c.py:213-222), batched on half spectra.

    signal_half: (F, kmax); f0: (F,).  in_low set: freqs < 1.2*f0; replica
    added where freqs < f0.  Gather-free (dsp.dcfill).
    """
    from ..dsp.dcfill import dc_fill_add

    return dc_fill_add(signal_half, f0, fs, fft_size, boundary_factor=1.2,
                       KL=256, dtype=dtype)


def rect_smooth_half(signal_full, width, fs, fft_size: int, dtype,
                     max_width_hz: float = 4000.0):
    """Rectangular smoothing of an even full spectrum (d4c.py:178-188,
    cheaptrick.py:103-116): cumsum high/low difference at per-frame ±width/2.

    The per-frame query offsets are CONSTANT along the bin axis, so the two
    lerped cumsum reads are per-row fractional SHIFTS of bounded range
    (|w/2| <= max_width_hz/2, i.e. ~w*fft_size/(2fs) bins): a radix
    shift-select + lerp, no gathers, no transcendentals.  All realistic
    smoothing widths (<= 2*f0_ceil) sit far inside the 4 kHz bound; the
    clip only engages for absurd f0 (> ~6 kHz).
    Returns (F, fft_size//2+1) == (cs(k*df+w/2) - cs(k*df-w/2)) / width.

    The lerped read cs(m+f) = cs[m] + f*x[m+1] makes the difference
    (cs[m1] - cs[m0]) + f1*x[m1+1] - f0*x[m0+1]; the integer-bounded part is
    taken from a compensated cumsum (dsp.scanops.compensated_cumsum), so a
    bin 60 dB below its frame's peak keeps float32 precision instead of
    inheriting the rounding of the running total.
    """
    df = fs / fft_size
    width = jnp.asarray(width)
    if width.ndim == 1:
        width = width[:, None]
    inc = jnp.concatenate([signal_full, signal_full], axis=-1) * df
    hi, lo = compensated_cumsum(inc)
    F = inc.shape[0]
    x0 = -fs + df / 2
    nb = fft_size // 2 + 1
    # query position for bin k: k + alpha with per-row alpha = (+-w/2 - x0)/df
    span = int(np.ceil(max_width_hz / 2 / df)) + 2
    center = fft_size  # alpha at width=0: (0 - x0)/df = fft_size - 1/2
    slab = jnp.concatenate([hi, lo, inc])[:, center - span :]

    def read(alpha):
        m = jnp.floor(alpha)
        frac = (alpha - m).astype(dtype)
        sh = jnp.clip(m.astype(jnp.int32) - (center - span),
                      0, 2 * span)[:, 0]
        v = shift_select_rows(slab, jnp.tile(sh, 3), 2 * span, nb + 1)
        return v[:F, :nb], v[F : 2 * F, :nb], v[2 * F :, 1 : nb + 1], frac

    h1, l1, x1, f1 = read((width / 2 - x0) / df)
    h0, l0, x0_, f0 = read((-width / 2 - x0) / df)
    return ((h1 - h0) + (l1 - l0) + (f1 * x1 - f0 * x0_)) / width


# backwards-compatible name
linear_smoothing_full_to_half = rect_smooth_half


def love_train_vuv(x, fs, f0, temporal_positions, threshold, max_half: int,
                   fft_size_lt: int, frame_period_ms=None):
    """'Love Train' VUV decision per frame (d4c.py:68-88), batched.

    The cumulative-power ratio needs only two prefix sums at static bin
    boundaries — plain slice-sums, no cumsum at all.
    """
    dtype = x.dtype
    df = fs / fft_size_lt
    b0 = int(np.ceil(100 / df) + 1)
    b1 = int(np.ceil(4000 / df) + 1)
    b2 = int(np.ceil(7900 / df) + 1)

    f0_c = jnp.maximum(f0, 40.0)
    t = temporal_positions.astype(dtype)
    seg = frame_segments(x, float(fs), t, max_half, frame_period_ms)
    waveform, _, _ = apply_adaptive_window(
        seg, float(fs), f0_c, t, 1.5, max_half, "blackman",
        sub_sample_shift=True)
    spec = jnp.fft.rfft(waveform, fft_size_lt)
    power = jnp.abs(spec) ** 2
    s1 = jnp.sum(power[:, b0:b1], axis=1)
    s2 = s1 + jnp.sum(power[:, b1:b2], axis=1)
    return ((s1 / s2) > threshold) & (f0 != 0)


def _centroid_from_slab(slab, margin, fs, f0, t_base, t_shifted, max_half: int,
                        fft_size: int):
    """get_centroid for one shifted window set (d4c.py:132-153), batched.

    The ±T0/4-shifted window is cut from the frame slab by a per-row integer
    shift (the only remaining row gather — bounded width)."""
    dtype = slab.dtype
    w0 = 2 * max_half + 1
    center_b = jnp.floor(t_base * fs + 0.501) + 1.0
    center_s = jnp.floor(t_shifted * fs + 0.501) + 1.0
    shift = jnp.clip((center_s - center_b).astype(jnp.int32) + margin,
                     0, 2 * margin)
    from ..dsp.scanops import shift_select_rows

    segment = shift_select_rows(slab, shift, 2 * margin, w0)
    waveform, mask, _ = apply_adaptive_window(
        segment, fs, f0, t_shifted, 2.0, max_half, "blackman",
        sub_sample_shift=True)
    half = jnp.floor(2.0 * fs / f0 + 0.5)[:, None]
    base_index = jnp.arange(-max_half, max_half + 1, dtype=dtype)[None, :]
    t_true = jnp.where(mask, base_index + half + 1, 0.0)
    xn = waveform / jnp.sqrt(jnp.sum(waveform ** 2, axis=1, keepdims=True))
    S = jnp.fft.rfft(xn, fft_size)
    U = jnp.fft.rfft(xn * t_true, fft_size)
    return S.real * U.real + S.imag * U.imag


def static_centroid_half(x, fs, f0, t_pos, max_half: int, fft_size: int, dtype,
                         frame_period_ms=None):
    margin = int(np.ceil(fs / (4 * 47.0))) + 3
    slab = frame_segments(x, float(fs), t_pos, max_half, frame_period_ms,
                          margin=margin)
    c1 = _centroid_from_slab(slab, margin, float(fs), f0, t_pos,
                             t_pos + 1 / f0 / 4, max_half, fft_size)
    c2 = _centroid_from_slab(slab, margin, float(fs), f0, t_pos,
                             t_pos - 1 / f0 / 4, max_half, fft_size)
    return dc_correction_half(c1 + c2, f0, float(fs), fft_size, dtype)


def smoothed_power_spectrum_half(x, fs, f0, t_pos, max_half: int, fft_size: int,
                                 dtype, frame_period_ms=None):
    seg = frame_segments(x, float(fs), t_pos, max_half, frame_period_ms)
    waveform, _, _ = apply_adaptive_window(
        seg, float(fs), f0, t_pos, 2.0, max_half, "hanning",
        sub_sample_shift=True)
    power = jnp.abs(jnp.fft.rfft(waveform, fft_size)) ** 2
    power = dc_correction_half(power, f0, float(fs), fft_size, dtype)
    return linear_smoothing_full_to_half(mirror_full(power), f0, float(fs),
                                         fft_size, dtype)


def static_group_delay_half(centroid_half, smoothed_power_half, fs, f0,
                            fft_size: int, dtype):
    """T_D(w) (d4c.py:165-174) on half bins, batched."""
    # reduced-precision guard (inactive on f64 golden fixtures; the
    # reference divides unguarded): the smoothed power can round to exactly
    # 0 on dead bins — clamp the divisor at a scale-relative tiny.  The
    # group delay itself legitimately reaches ~1e6 on weak bins; the
    # compensated smoothing (rect_smooth_half) keeps such bins from
    # spoiling their neighbours, so no clip is needed.
    eps = jnp.finfo(dtype).eps
    floor = jnp.mean(jnp.abs(smoothed_power_half), axis=-1, keepdims=True) * eps * eps
    den = jnp.where(jnp.abs(smoothed_power_half) < floor,
                    floor, smoothed_power_half)
    gd = centroid_half / den
    gd = linear_smoothing_full_to_half(mirror_full(gd), f0 / 2, float(fs),
                                       fft_size, dtype)
    gd_s = linear_smoothing_full_to_half(mirror_full(gd), f0, float(fs),
                                         fft_size, dtype)
    return gd - gd_s


def coarse_aperiodicity(group_delay_half, fs: float, fft_size: int,
                        frequency_interval: float, n_ap: int, window: np.ndarray,
                        dtype):
    """Per-band aperiodicity from the group delay (d4c.py:192-209), batched.

    group_delay_half: (F, fft//2+1).  Returns (F, n_ap).
    """
    wlen = len(window)
    boundary = int(fft_size / wlen * 8 + 0.5)
    hw = wlen // 2
    gd_full = mirror_full(group_delay_half)
    segs = []
    for i in range(n_ap):
        center = int(np.floor(frequency_interval * (i + 1) / (fs / fft_size)))
        segs.append(gd_full[..., center - hw : center + hw + 1])
    seg = jnp.stack(segs, axis=-2) * jnp.asarray(window, dtype=dtype)
    power = jnp.abs(jnp.fft.rfft(seg, fft_size)) ** 2
    # reference: cumsum(sort(power))[n - boundary - 2] / total — i.e. the sum
    # of all but the (boundary+1) largest values.  top_k replaces the full
    # sort (top_k with small k is cheaper than a full sort).
    den = jnp.sum(power, axis=-1)
    largest, _ = jax.lax.top_k(power, boundary + 1)
    num = den - jnp.sum(largest, axis=-1)
    tiny = jnp.finfo(dtype).tiny  # 0/0 guard for all-zero bands (f32 only)
    return -10.0 * jnp.log10((num + tiny) / (den + tiny))


def band_window(fs: int, fft_size: int, frequency_interval: float) -> np.ndarray:
    wl = int(np.floor(frequency_interval / (fs / fft_size)) * 2 + 1)
    return np_nuttall(wl)


def coarse_ap_frames(x, fs, f0, t_pos, frequency_interval, fft_size: int,
                     n_ap: int, window: np.ndarray, max_half: int, dtype,
                     frame_period_ms=None):
    """estimate_one_slice (d4c.py:114-128) for all frames at once."""
    centroid = static_centroid_half(x, fs, f0, t_pos, max_half, fft_size, dtype,
                                    frame_period_ms)
    spsh = smoothed_power_spectrum_half(x, fs, f0, t_pos, max_half, fft_size,
                                        dtype, frame_period_ms)
    gd = static_group_delay_half(centroid, spsh, fs, f0, fft_size, dtype)
    return coarse_aperiodicity(gd, float(fs), fft_size, frequency_interval,
                               n_ap, window, dtype)
