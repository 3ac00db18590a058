"""DIO F0 estimator — a fixed-shape batched reformulation.

Mirrors /root/reference/world/dio.py (API and outputs) with a different
execution design:
  * the downsampler's sequential IIR runs as an associative-scan linear
    recurrence (dsp.iir.decimate_world);
  * the ~7 band low-pass filters are one batched FFT product;
  * ragged zero-crossing event lists are fixed-capacity compacted buffers;
  * the 4 sequential contour-fix passes become: two vectorized passes
    (step1/step2 are data-parallel) and two lax.scan passes whose carried
    state reproduces the reference's forward/backward candidate propagation.
"""
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..dsp.iir import decimate_world
from ..dsp.rounding import round_half_even_decimals
from ..dsp.windows import np_hanning_matlab, np_nuttall


# ---------------------------------------------------------------------------
# candidate generation
# ---------------------------------------------------------------------------

def _low_cut_taps(actual_fs: float):
    """The low-cut FIR of get_spectrum (dio.py:80-85), un-rolled taps + the
    circular-shift offset the reference's spectrum-domain roll induces."""
    cutoff_in_sample = int(actual_fs / 50 + 0.5)
    w = np_hanning_matlab(2 * cutoff_in_sample + 1)
    taps = -w / w.sum()
    taps[cutoff_in_sample] += 1.0
    return taps, cutoff_in_sample


def _band_bank(boundary_f0_list: np.ndarray, actual_fs: float):
    """Combined (low-cut * band-lowpass) FIR bank + per-band read offsets.

    The reference multiplies three spectra (signal, rolled low-cut, band
    low-pass) at full-signal FFT size (dio.py:87,132-134); that equals one
    linear convolution with host-combined taps read at offset
    argmax(band)+1+cutoff.
    """
    lcf, cutoff = _low_cut_taps(actual_fs)
    lens = [int(actual_fs / bf / 2 + 0.5) * 4 for bf in boundary_f0_list]
    combined = [np.convolve(lcf, np_nuttall(n)) for n in lens]
    max_len = max(len(c) for c in combined)
    bank = np.zeros((len(lens), max_len))
    offsets = np.zeros(len(lens), dtype=np.int64)
    for i, (c, n) in enumerate(zip(combined, lens)):
        bank[i, : len(c)] = c
        offsets[i] = int(np.argmax(np_nuttall(n))) + 1 + cutoff
    return bank, offsets


def _candidates_and_stability(y, actual_fs, f0_floor, f0_ceil, boundary_f0_list,
                              temporal_positions, frame_period):
    from ..dsp.fir import fir_bank_full
    from ..dsp.scanops import take_rows
    from .events import four_event_interp

    bank, offsets = _band_bank(boundary_f0_list, actual_fs)
    y_len = y.shape[0]
    block = 16384 if y_len > 65536 else None
    conv = fir_bank_full(y, bank, block=block)
    # per-band offsets are host-known -> static slices, no gather
    filtered = jnp.stack([conv[b, int(s) : int(s) + y_len]
                          for b, s in enumerate(offsets)])

    stride = actual_fs * frame_period / 1000.0
    f0c, dev, _ = four_event_interp(filtered, actual_fs, temporal_positions,
                                    stride)
    bf = jnp.asarray(boundary_f0_list, dtype=y.dtype)[:, None]
    bad = ((f0c > bf) | (f0c < bf / 2) | (f0c > f0_ceil) | (f0c < f0_floor))
    f0c = jnp.where(bad, 0.0, f0c)
    dev = jnp.where(f0c == 0, 100000.0, dev)
    stability = jnp.exp(-(dev / jnp.maximum(f0c, 0.0000001)))
    return f0c, stability


# ---------------------------------------------------------------------------
# contour fixing (dio.py:216-326)
# ---------------------------------------------------------------------------

def _select_best_f0(current_f0, past_f0, candidates, allowed_range):
    """Vectorized select_best_f0 (dio.py:297-310): nearest candidate to the
    linear prediction, zeroed when relative error exceeds allowed_range."""
    eps = np.finfo(np.float64).eps
    reference_f0 = (current_f0 * 3 - past_f0) / 2
    errors = jnp.abs(reference_f0 - candidates)
    best = candidates[jnp.argmin(errors)]
    ok = jnp.abs(1 - best / (reference_f0 + eps)) <= allowed_range
    return jnp.where(ok, best, 0.0)


def _fix_step1(f0_cands, voice_range_minimum: int, allowed_range):
    """Zero rapid changes; the reference mutates the first candidate row's
    edges in place (dio.py:237-247) — replicated functionally here.
    Returns (f0_step1, mutated_candidates)."""
    n = f0_cands.shape[1]
    f0_base = f0_cands[0]
    idx = jnp.arange(n)
    edge = (idx < voice_range_minimum) | (idx >= n - voice_range_minimum)
    f0_base = jnp.where(edge, 0.0, f0_base)
    r = round_half_even_decimals(f0_base, 6)
    r_prev = jnp.concatenate([r[:1], r[:-1]])
    rapid = jnp.abs((r - r_prev) / (0.000001 + r)) > allowed_range
    apply = idx >= voice_range_minimum - 1
    f0_step1 = jnp.where(apply & rapid, 0.0, f0_base)
    return f0_step1, f0_cands.at[0].set(f0_base)


def _fix_step2(f0_step1, voice_range_minimum: int):
    """Zero frames whose ±(vrm-1)/2 window contains any zero (dio.py:252-259)."""
    n = f0_step1.shape[0]
    hw = (voice_range_minimum - 1) // 2
    z = (f0_step1 == 0).astype(jnp.int32)
    c = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(z)])
    i = jnp.arange(n)
    lo = i - hw
    hi = i + hw  # inclusive
    any_zero = (c[hi + 1] - c[lo]) > 0
    inner = (i >= hw) & (i < n - hw)
    return jnp.where(inner & any_zero, 0.0, f0_step1)


def _section_flags(f0):
    """Voiced-section start/end flags + step3/step4 propagation limits."""
    n = f0.shape[0]
    v = f0 != 0
    i = jnp.arange(n)
    v_prev = jnp.concatenate([jnp.asarray([False]), v[:-1]])
    v_next = jnp.concatenate([v[1:], jnp.asarray([False])])
    is_start = v & ~v_prev
    is_end = v & ~v_next
    # next section start strictly after p (suffix scan), else n-1
    big = n + 10
    starts = jnp.where(is_start, i, big)
    next_start_incl = jax.lax.cummin(starts[::-1])[::-1]  # min start >= p
    next_start_after = jnp.concatenate([next_start_incl[1:], jnp.asarray([big])])
    step3_limit = jnp.where(next_start_after >= big, n - 1, next_start_after + 1)
    # previous section end strictly before p (prefix scan), else 1
    ends = jnp.where(is_end, i, -1)
    prev_end_incl = jax.lax.cummax(ends)
    prev_end_before = jnp.concatenate([jnp.asarray([-1]), prev_end_incl[:-1]])
    step4_limit = jnp.where(prev_end_before < 0, 1, prev_end_before)
    return is_start, is_end, step3_limit, step4_limit


def _fix_step3(f0_step2, f0_cands, allowed_range):
    """Forward extension scan (dio.py:264-277).

    The reference iterates sections, propagating a candidate chain from each
    voiced-section end until the next section's start+1 or a zero pick.  A
    single forward lax.scan with carried (prev, prev2, active, limit)
    reproduces the identical write sequence.
    """
    n = f0_step2.shape[0]
    _, is_end, step3_limit, _ = _section_flags(f0_step2)

    def body(carry, inp):
        prev1, prev2, active, limit = carry
        base_val, end_flag, p, lim_here, cands = inp
        in_ext = active & (p <= limit)
        ext_val = _select_best_f0(prev1, prev2, cands, allowed_range)
        val = jnp.where(in_ext, ext_val, base_val)
        active = in_ext & (ext_val != 0)
        # activate extension when p is a section end (original f0_step2 sections)
        active = jnp.where(end_flag, True, active)
        limit = jnp.where(end_flag, lim_here, limit)
        return (val, prev1, active, limit), val

    init = (jnp.asarray(0.0, f0_step2.dtype), jnp.asarray(0.0, f0_step2.dtype),
            jnp.asarray(False), jnp.asarray(0))
    xs = (f0_step2, is_end, jnp.arange(n), step3_limit, f0_cands.T)
    _, out = jax.lax.scan(body, init, xs)
    return out


def _fix_step4(f0_step3, f0_step2_sections_src, f0_cands, allowed_range):
    """Backward extension scan (dio.py:281-293), mirror of step3.

    Sections/limits come from f0_step2 (the reference computes section_list
    before step3 and reuses it)."""
    n = f0_step3.shape[0]
    is_start, _, _, step4_limit = _section_flags(f0_step2_sections_src)

    def body(carry, inp):
        prev1, prev2, active, limit = carry
        base_val, start_flag, p, lim_here, cands = inp
        in_ext = active & (p >= limit - 1)
        ext_val = _select_best_f0(prev1, prev2, cands, allowed_range)
        val = jnp.where(in_ext, ext_val, base_val)
        active = in_ext & (ext_val != 0)
        active = jnp.where(start_flag, True, active)
        limit = jnp.where(start_flag, lim_here, limit)
        return (val, prev1, active, limit), val

    init = (jnp.asarray(0.0, f0_step3.dtype), jnp.asarray(0.0, f0_step3.dtype),
            jnp.asarray(False), jnp.asarray(0))
    xs = (f0_step3[::-1], is_start[::-1], jnp.arange(n)[::-1],
          step4_limit[::-1], f0_cands.T[::-1])
    _, out = jax.lax.scan(body, init, xs)
    return out[::-1]


def fix_f0_contour(f0_candidates, frame_period, f0_floor, allowed_range):
    voice_range_minimum = int(1 / (frame_period / 1000) / f0_floor + 0.5) * 2 + 1
    f0_step1, cands_mut = _fix_step1(f0_candidates, voice_range_minimum, allowed_range)
    f0_step2 = _fix_step2(f0_step1, voice_range_minimum)
    f0_step3 = _fix_step3(f0_step2, cands_mut, allowed_range)
    f0_step4 = _fix_step4(f0_step3, f0_step2, cands_mut, allowed_range)
    vuv = jnp.where(f0_step4 != 0, 1.0, 0.0)
    return f0_step4, vuv, (f0_step1, f0_step2, f0_step3, cands_mut)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("fs", "f0_floor", "f0_ceil", "channels_in_octave",
                                   "target_fs", "frame_period", "allowed_range",
                                   "signal_length"))
def _dio_core(x, fs, f0_floor, f0_ceil, channels_in_octave, target_fs,
              frame_period, allowed_range, signal_length):
    num_samples = int(1000 * signal_length / fs / frame_period + 1)
    # host-side numpy: XLA rewrites x*p/1000 into x*(p/1000) which breaks
    # bit-parity with the reference grid (dio.py:29) and shifts stonemask's
    # window rounding; the grid is static so bake it as a constant
    temporal_positions = jnp.asarray(
        np.arange(num_samples) * frame_period / 1000, dtype=x.dtype)
    boundary_f0_list = f0_floor * 2.0 ** (
        (np.arange(math.ceil(np.log2(f0_ceil / f0_floor) * channels_in_octave)) + 1)
        / channels_in_octave)

    r = int(fs / target_fs)
    y = decimate_world(x, r)
    actual_fs = float(target_fs)
    duration = signal_length / fs
    raw_f0, raw_stab = _candidates_and_stability(
        y, actual_fs, f0_floor, f0_ceil, boundary_f0_list, temporal_positions,
        frame_period)

    order = jnp.argsort(-raw_stab, axis=0)
    f0_candidates = jnp.take_along_axis(raw_f0, order, axis=0)
    f0_scores = jnp.take_along_axis(raw_stab, order, axis=0)

    f0, vuv, _ = fix_f0_contour(f0_candidates, frame_period, f0_floor, allowed_range)
    return dict(f0=f0, f0_candidates=f0_candidates, raw_f0_candidates=raw_f0,
                temporal_positions=temporal_positions, vuv=vuv,
                _f0_scores=f0_scores, _raw_stability=raw_stab)


def dio(x, fs, f0_floor=71, f0_ceil=800, channels_in_octave=2, target_fs=4000,
        frame_period=5, allowed_range=0.1):
    """F0 estimation by DIO (API-compatible with the reference dio.py:10-55)."""
    x = jnp.asarray(x)
    out = _dio_core(x, int(fs), float(f0_floor), float(f0_ceil),
                    int(channels_in_octave), int(target_fs), float(frame_period),
                    float(allowed_range), x.shape[0])
    return {k: v for k, v in out.items() if not k.startswith("_")} | {
        "_f0_scores": out["_f0_scores"], "_raw_stability": out["_raw_stability"]}
