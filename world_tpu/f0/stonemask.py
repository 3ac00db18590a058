"""StoneMask F0 refinement — instantaneous frequency at harmonic DFT bins.

Mirrors /root/reference/world/stonemask.py semantically, but with a key
reformulation: the reference computes, per frame, two FFTs of a
data-dependent size and then reads the spectrum at only 2 (pass 1) / 6
(pass 2) harmonic bins.  Here each needed bin is computed directly as a dot
product between the windowed segment and that bin's DFT vector — the
data-dependent fft_size becomes a mere scalar in the phase formula, every
frame shares one static segment length, and all frames batch into a handful
of einsums, with no FFT at all.
"""
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..dsp.rounding import matlab_round_half, round_half_even_decimals, round_matlab
from ..frames import gather_trunc_1based


def _dft_bins(segment, bins, fft_size):
    """DFT of ``segment`` at integer ``bins`` of an fft of size ``fft_size``.

    segment: (L,); bins: (K,) integer-valued floats; fft_size: scalar float.
    Returns complex (K,) == np.fft.fft(segment, fft_size)[bins] exactly
    (segment is zero-padded to fft_size by construction: L <= fft_size).
    """
    # exact integer angle reduction: bins and n are integers and fft_size a
    # power of two, so (bins*n) mod fft_size is exact in int32 and the
    # resulting |theta| < 2*pi — f32 trig at large arguments (|theta| up to
    # ~36*pi here) costs ~1e-5 rad of argument rounding plus the
    # accelerator's reduction error, which fed the refined-f0 20%-change
    # threshold (stonemask.py:25-26)
    n_i = jnp.arange(segment.shape[0], dtype=jnp.int32)
    m = (bins.astype(jnp.int32)[:, None] * n_i[None, :]
         ) % fft_size.astype(jnp.int32)
    theta = (-2.0 * jnp.pi) * (m.astype(segment.dtype) / fft_size)
    # HIGHEST: the IF ratios feed a 20%-change rejection threshold
    # (stonemask.py:25-26); a bf16 DEFAULT pass flips borderline frames
    hp = jax.lax.Precision.HIGHEST
    re = jnp.dot(jnp.cos(theta), segment, precision=hp,
                 preferred_element_type=segment.dtype)
    im = jnp.dot(jnp.sin(theta), segment, precision=hp,
                 preferred_element_type=segment.dtype)
    return re, im


def _refine_one(x, fs, current_time, current_f0, max_half: int):
    """get_refined_f0 (stonemask.py:30-76) with harmonic-bin DFTs."""
    eps = jnp.finfo(x.dtype).eps
    f0_initial = current_f0
    half_window_length = jnp.ceil(3 * fs / f0_initial / 2)
    window_length_in_time = (2 * half_window_length + 1) / fs
    fft_size = 2.0 ** (jnp.ceil(jnp.log2(half_window_length * 2 + 1)) + 1)

    base_index = jnp.arange(-max_half, max_half + 1, dtype=x.dtype)
    mask = jnp.abs(base_index) <= half_window_length
    base_time = round_half_even_decimals(base_index / fs, 4)
    # the reference's round_matlab keeps the +/-0.5 offset un-truncated and
    # uses it IN THE WINDOW TIME (stonemask.py:39-44); only the gather index
    # truncates.
    index_raw = matlab_round_half((current_time + base_time) * fs)
    index_time = (index_raw - 1) / fs
    window_time = index_time - current_time
    main_window = (0.42 + 0.5 * jnp.cos(2 * jnp.pi * window_time / window_length_in_time)
                   + 0.08 * jnp.cos(4 * jnp.pi * window_time / window_length_in_time))
    main_window = jnp.where(mask, main_window, 0.0)
    # diff_window = -(diff([0,w]) + diff([w,0]))/2 == -(w[i+1]-w[i-1])/2 with
    # zero boundaries; the mask keeps the reference's finite-window edges.
    w_pad = jnp.concatenate([jnp.zeros(1, x.dtype), main_window, jnp.zeros(1, x.dtype)])
    diff_window = -(w_pad[2:] - w_pad[:-2]) / 2
    diff_window = jnp.where(mask, diff_window, 0.0)

    seg = gather_trunc_1based(x, index_raw) * mask
    seg_main = seg * main_window
    seg_diff = seg * diff_window

    def harmonic_pass(f0_est, trim_index):
        from ..ops import prod_diff

        bins = round_matlab(f0_est * fft_size / fs * trim_index)  # then +1, 1-based
        re_s, im_s = _dft_bins(seg_main, bins, fft_size)
        re_d, im_d = _dft_bins(seg_diff, bins, fft_size)
        # compensated in f32: same cancellation-prone difference of products
        # as harvest's IF numerator (ops.prod_diff docstring).  NOTE: this is
        # hygiene, not the cause of the dio path's ~1.95 Hz f32-vs-f64 RMSE
        # at 22.05 kHz — that tail comes from decision-boundary chaos (the
        # 20%-change rejection at :98 and integer bin rounding at :81
        # feeding pass 2), not from arithmetic noise; the median frame
        # error is 6e-4 Hz on the CPU in f32.
        numerator_i = prod_diff(re_s, im_d, im_s, re_d)
        power = re_s ** 2 + im_s ** 2
        power = jnp.maximum(power, eps)
        fx = bins / fft_size * fs
        inst_freq = fx + numerator_i / power * fs / 2 / jnp.pi
        amp = jnp.sqrt(power)
        return jnp.sum(amp * inst_freq) / jnp.sum(amp * trim_index)

    trim2 = jnp.arange(1, 3, dtype=x.dtype)
    f0_pass1 = harmonic_pass(f0_initial, trim2)
    trim6 = jnp.arange(1, 7, dtype=x.dtype)
    f0_pass2 = harmonic_pass(f0_pass1, trim6)
    refined = jnp.where(f0_pass1 < 0, 0.0, f0_pass2)

    keep = jnp.abs(refined - current_f0) / jnp.maximum(current_f0, eps) > 0.2
    refined = jnp.where(keep, current_f0, refined)
    return jnp.where(current_f0 != 0, refined, 0.0)


@partial(jax.jit, static_argnames=("fs", "max_half"))
def _stonemask_core(x, fs, temporal_positions, f0, max_half):
    fn = jax.vmap(lambda t, f: _refine_one(x, float(fs), t, f, max_half))
    return fn(temporal_positions, jnp.maximum(f0, 1e-12))


def stonemask(x, fs, temporal_positions, f0, f0_floor=71.0):
    """Refine an F0 contour by instantaneous frequency (stonemask.py:8-27)."""
    x = jnp.asarray(x)
    f0 = jnp.asarray(f0)
    max_half = int(math.ceil(3 * fs / f0_floor / 2))
    refined = _stonemask_core(x, int(fs), jnp.asarray(temporal_positions), f0, max_half)
    return jnp.where(f0 != 0, refined, f0)
