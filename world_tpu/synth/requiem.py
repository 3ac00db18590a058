"""Requiem synthesis: excitation generation + spectral filtering.

Semantics from /root/reference/world/synthesisRequiem.py:12-141;
batch-first execution:
  * the per-band looped velvet noise (whose reference implementation hides a
    persistent cursor in a function attribute, synthesisRequiem.py:131-141)
    becomes an explicit modular gather with caller-supplied offsets —
    stateless and deterministic;
  * the per-pulse loop becomes ONE (pulses, bands) x (bands, fft) matmul +
    masked scatter-add;
  * the per-frame filtering loop becomes batched min-phase cepstra and FFT
    convolutions over all frames at once.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..dsp.interp import interp1_extrap
from ..dsp.minphase import minimum_phase_spectrum, mirror_full
from ..dsp.windows import np_hanning_matlab


def _pulse_locations(temporal_positions, f0, vuv, fs, time_axis, max_pulses: int,
                     frame_period_s=None):
    """time_base_generation (synthesisRequiem.py:104-118): no time shift."""
    from .classic import grid_interp

    if frame_period_s is not None:
        f0_i = grid_interp(f0, temporal_positions, time_axis, frame_period_s)
        vuv_i = grid_interp(vuv, temporal_positions, time_axis,
                            frame_period_s) > 0.5
    else:
        f0_i = interp1_extrap(temporal_positions, f0, time_axis)
        vuv_i = interp1_extrap(temporal_positions, vuv, time_axis) > 0.5
    f0_i = jnp.where(vuv_i, f0_i, 0.0)
    f0_i = jnp.where(f0_i == 0, 500.0, f0_i)
    total_phase = jnp.cumsum(2 * jnp.pi * f0_i / fs)
    wrap = jnp.remainder(total_phase, 2 * jnp.pi)
    mask = jnp.abs(jnp.diff(wrap)) > jnp.pi
    slot = jnp.where(mask, jnp.cumsum(mask) - 1, max_pulses)
    raw_count = jnp.sum(mask)
    count = jnp.minimum(raw_count, max_pulses)
    locs = jnp.zeros(max_pulses, time_axis.dtype).at[slot].set(
        jnp.where(mask, time_axis[:-1], 0.0), mode="drop")
    pli = jnp.floor(locs * fs + 0.5).astype(jnp.int32) + 1
    return pli, count, vuv_i, raw_count


@partial(jax.jit, static_argnames=("fs", "y_length", "max_pulses", "k_overlap",
                                   "frame_period_s"))
def _excitation_core(temporal_positions, f0, vuv, band_ap_db, pulse_seed,
                     noise_seed, noise_offsets, fs, y_length, max_pulses,
                     k_overlap=40, frame_period_s=None):
    dtype = pulse_seed.dtype
    fft_size = pulse_seed.shape[0]
    n_bands = pulse_seed.shape[1]
    time_axis = jnp.arange(y_length, dtype=dtype) / fs + temporal_positions[0]
    pli, count, vuv_i, raw_count = _pulse_locations(
        temporal_positions, f0, vuv, float(fs), time_axis, max_pulses,
        frame_period_s)

    # band aperiodicity resampled to the sample grid (linear in 10^(dB/10))
    ap_lin = 10.0 ** (band_ap_db / 10.0)      # (bands, frames)
    if frame_period_s is not None:
        from .classic import grid_interp

        interp_ap = grid_interp(ap_lin, temporal_positions, time_axis,
                                frame_period_s)
    else:
        interp_ap = jax.vmap(lambda row: interp1_extrap(
            temporal_positions, row, time_axis))(ap_lin)

    # aperiodic component: per-band tiled velvet noise x interpolated ap
    noise_len = noise_seed.shape[0]
    reps = int(np.ceil(y_length / noise_len)) + 1
    tiled = jnp.tile(noise_seed.T, (1, reps))             # (bands, reps*len)
    noise = jax.vmap(lambda row, off: jax.lax.dynamic_slice(
        row, (off,), (y_length,)))(tiled, noise_offsets % noise_len)
    aperiodic = jnp.sum(noise * interp_ap, axis=0)

    # periodic component: (pulses, bands) weights x (bands, fft) seeds
    pulse_ids = jnp.arange(max_pulses)
    valid = pulse_ids < count
    ap_at_pulse = interp_ap[:, jnp.clip(pli - 1, 0, y_length - 1)]  # (bands, P)
    voiced = (jnp.take(vuv_i, jnp.clip(pli - 1, 0, y_length - 1))
              & (ap_at_pulse[0] <= 0.999) & valid)
    next_pli = jnp.take(pli, jnp.minimum(jnp.minimum(pulse_ids + 1, count - 1),
                                         max_pulses - 1))
    noise_size = jnp.sqrt(jnp.maximum(1.0, (next_pli - pli).astype(dtype)))
    weights = (1.0 - ap_at_pulse.T) * jnp.where(voiced, noise_size, 0.0)[:, None]
    # (P, fft): the contraction runs over the few (3-7) bands, so it is an
    # explicit sum of exact float32 products rather than a dot whose
    # precision the backend picks
    responses = sum(weights[:, b, None] * pulse_seed[None, :, b]
                    for b in range(n_bands))
    # overlap-add: slotted matmul OLA (dsp.ola); padded pulses park past the
    # tail.  k_overlap retained in the signature for compatibility.
    del k_overlap
    starts = jnp.where(valid, pli - fft_size // 2,
                       y_length + fft_size + 2).astype(jnp.int32)
    from ..dsp.ola import slotted_ola

    periodic = slotted_ola(responses, starts, y_length, slot=32)
    return periodic + aperiodic, raw_count > max_pulses


@partial(jax.jit, static_argnames=("fs", "fft_size", "fps"))
def _waveform_core(excitation, spectrogram, temporal_positions, fs, fft_size,
                   fps):
    """get_waveform (synthesisRequiem.py:74-101), batched over frames."""
    dtype = excitation.dtype
    n_frames = spectrogram.shape[1]
    y_len = excitation.shape[0]
    win_len = fps * 2 - 1
    half = fps - 1
    win = jnp.asarray(np_hanning_matlab(win_len), dtype=dtype)

    frames = jnp.arange(2, n_frames - 1)
    origins = (frames - 1) * fps - half  # 1-based origin

    seg_idx = jnp.minimum(y_len, origins[:, None]
                          + jnp.arange(win_len)[None, :]) - 1
    tmp = jnp.take(excitation, seg_idx) * win[None, :]
    spec = spectrogram.T[1:n_frames - 2]  # frame i uses column i-1
    # frame count padded to a block multiple: each frame's FFTs then round
    # the same way whatever the batch around them (see cheaptrick.py)
    n_used = tmp.shape[0]
    pad = (-n_used) % 32
    tmp = jnp.pad(tmp, ((0, pad), (0, 0)))
    spec = jnp.pad(spec, ((0, pad), (0, 0)), constant_values=1.0)
    mp = minimum_phase_spectrum(mirror_full(spec))
    resp = jnp.fft.ifft(mp * jnp.fft.fft(tmp, fft_size)).real[:n_used]
    from ..dsp.ola import uniform_ola

    return uniform_ola(resp, fps - half - 1, fps, y_len)


def synthesis_requiem(source_object, filter_object, seeds_signals,
                      noise_offsets=None, max_pulses=None):
    """Excitation-based synthesis (API mirrors synthesisRequiem.py:12-25)."""
    f0 = np.asarray(source_object["f0"], dtype=np.float64)
    vuv = np.asarray(source_object["vuv"], dtype=np.float64)
    tp = np.asarray(source_object["temporal_positions"], dtype=np.float64)
    spectrogram = jnp.asarray(filter_object["spectrogram"])
    band_ap = jnp.asarray(source_object["aperiodicity"])
    fs = int(filter_object["fs"])
    pulse_seed = jnp.asarray(seeds_signals["pulse"])
    noise_seed = jnp.asarray(seeds_signals["noise"])

    y_length = len(np.arange(tp[0], tp[-1] + 1 / fs, 1.0 / fs))
    if max_pulses is None:
        est = int(np.ceil((tp[-1] - tp[0]) * max(500.0, float(f0.max()) * 1.2))) + 8
        max_pulses = int(2 ** np.ceil(np.log2(est)))
    if noise_offsets is None:
        noise_offsets = jnp.zeros(pulse_seed.shape[1], jnp.int32)

    fft_seed = int(pulse_seed.shape[0])
    f0_hi = max(500.0, float(f0.max()) * 1.1)
    k_overlap = min(int(np.ceil(fft_seed * f0_hi / fs)) + 8, max_pulses)
    k_overlap = int(np.ceil(k_overlap / 8) * 8)
    from ..frames import uniform_frame_period_ms

    fp_ms = uniform_frame_period_ms(tp)
    fp_s = None if fp_ms is None else fp_ms / 1000.0
    excitation, pulse_overflow = _excitation_core(
        jnp.asarray(tp), jnp.asarray(f0), jnp.asarray(vuv), band_ap,
        pulse_seed, noise_seed, noise_offsets, fs, y_length, max_pulses,
        k_overlap, fp_s)
    if bool(np.asarray(pulse_overflow)):
        import warnings

        warnings.warn(
            f"synthesis_requiem: pulse count exceeded max_pulses="
            f"{max_pulses}; trailing pulses were dropped — raise max_pulses",
            RuntimeWarning, stacklevel=2)
    fft_size = (spectrogram.shape[0] - 1) * 2
    # rounded: a float32 time axis gives 79.9999 samples for a 5 ms hop
    fps = int(round((tp[1] - tp[0]) * fs))
    return _waveform_core(excitation, spectrogram, jnp.asarray(tp), fs,
                          int(fft_size), fps)
