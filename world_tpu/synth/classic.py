"""Classic WORLD synthesis (pulse train + filtered noise overlap-add).

Semantics from /root/reference/world/synthesis.py:21-250; execution is
batch-first:
  * pulse positions come from a phase-wrap cumsum, compacted into a
    fixed-capacity pulse table;
  * the per-pulse Python loop becomes ONE vmap: batched 2-frame spectral
    lerp, batched minimum-phase cepstrum FFTs, batched noise convolution;
  * overlap-add is a masked scatter-add (y.at[idx].add);
  * noise comes from jax.random with explicit keys (parity with the
    reference's np.random is statistical, not bitwise).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..dsp.interp import interp1_extrap
from ..dsp.minphase import minimum_phase_spectrum, mirror_full
from ..dsp.windows import np_hanning_matlab


def grid_interp(values, temporal_positions, queries, frame_period_s):
    """interp1d(tp, values, fill_value='extrapolate') when tp is the uniform
    frame grid: direct index arithmetic instead of a binary search.
    values: (..., n)."""
    n = values.shape[-1]
    pos = (queries - temporal_positions[0]) / frame_period_s
    j = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, n - 2)
    frac = pos - j
    y0 = values[..., j]
    y1 = values[..., j + 1]
    return y0 + (y1 - y0) * frac


def _time_base(temporal_positions, f0, vuv, fs, time_axis, default_f0,
               max_pulses: int, wrap_threshold=jnp.pi, frame_period_s=None):
    """Pulse locations from the wrapped phase (synthesis.py:120-140).

    ``wrap_threshold`` pi/2 reproduces the older synthesis_a variant's pulse
    detection (synthesis_a.py:113-115)."""
    if frame_period_s is not None:
        f0_interp = grid_interp(f0, temporal_positions, time_axis, frame_period_s)
        vuv_interp = grid_interp(vuv, temporal_positions, time_axis,
                                 frame_period_s) > 0.5
    else:
        f0_interp = interp1_extrap(temporal_positions, f0, time_axis)
        vuv_interp = interp1_extrap(temporal_positions, vuv, time_axis) > 0.5
    f0_interp = jnp.where(vuv_interp, f0_interp, 0.0)
    f0_interp = jnp.where(f0_interp == 0, default_f0, f0_interp)

    total_phase = jnp.cumsum(2 * jnp.pi * f0_interp / fs)
    wrap_phase = jnp.remainder(total_phase, 2 * jnp.pi)
    dwrap = jnp.abs(jnp.diff(wrap_phase))
    mask = dwrap > wrap_threshold
    n = mask.shape[0]
    slot = jnp.where(mask, jnp.cumsum(mask) - 1, max_pulses)
    raw_count = jnp.sum(mask)
    count = jnp.minimum(raw_count, max_pulses)
    pulse_locations = jnp.zeros(max_pulses, time_axis.dtype).at[slot].set(
        jnp.where(mask, time_axis[:-1], 0.0), mode="drop")
    pli = jnp.floor(pulse_locations * fs + 0.5).astype(jnp.int32) + 1
    y1 = jnp.take(wrap_phase, pli - 1) - 2.0 * jnp.pi
    y2 = jnp.take(wrap_phase, jnp.minimum(pli, n))
    shift = (-y1 / (y2 - y1)) / fs
    return pulse_locations, pli, shift, vuv_interp, count, raw_count


@partial(jax.jit, static_argnames=("fs", "y_length", "fft_size", "max_pulses",
                                   "max_noise", "noise_mode", "variant",
                                   "k_overlap", "frame_period_s"))
def _synthesis_core(f0, vuv, temporal_positions, spectrogram, aperiodicity,
                    key, fs, y_length, fft_size, max_pulses, max_noise,
                    noise_mode, variant="standard", k_overlap=48,
                    frame_period_s=None):
    dtype = spectrogram.dtype
    default_f0 = 500.0
    time_axis = jnp.arange(y_length, dtype=dtype) / fs + temporal_positions[0]
    wrap_threshold = jnp.pi if variant == "standard" else jnp.pi / 2
    pulse_locations, pli, shifts, vuv_interp, count, raw_count = _time_base(
        temporal_positions, f0, vuv, float(fs), time_axis, default_f0,
        max_pulses, wrap_threshold, frame_period_s)
    if variant == "a":  # synthesis_a: no fractional time shift
        shifts = jnp.zeros_like(shifts)

    n_frames = temporal_positions.shape[0]
    frame_ids = jnp.arange(1, n_frames + 1, dtype=dtype)
    if frame_period_s is not None:
        tpi = grid_interp(frame_ids, temporal_positions, pulse_locations,
                          frame_period_s)
    else:
        tpi = interp1_extrap(temporal_positions, frame_ids, pulse_locations)
    tpi = jnp.clip(tpi, 1.0, float(n_frames))

    S = spectrogram.T                     # (frames, bins)
    AP = (aperiodicity ** 2).T
    PER = jnp.maximum(0.001, 1.0 - AP)

    dc_base = np_hanning_matlab(fft_size)
    dc_base = jnp.asarray(dc_base / dc_base.sum(), dtype=dtype)
    coefficient = 2.0 * jnp.pi * fs / fft_size
    half_k = jnp.arange(fft_size // 2 + 1, dtype=dtype)

    pulse_ids = jnp.arange(max_pulses)
    valid = pulse_ids < count
    next_pli = jnp.take(pli, jnp.minimum(jnp.minimum(pulse_ids + 1, count - 1),
                                         max_pulses - 1))
    noise_sizes = jnp.where(valid, next_pli - pli, 0)

    # ---- 2-frame spectral lerp, all pulses at once ------------------------
    floor_i = jnp.floor(tpi).astype(jnp.int32) - 1
    ceil_i = jnp.ceil(tpi).astype(jnp.int32) - 1
    t1 = jnp.take(temporal_positions, floor_i)
    t2 = jnp.take(temporal_positions, ceil_i)
    xq = jnp.maximum(t1, jnp.minimum(t2, pulse_locations))
    b = jnp.where(t1 == t2, 0.0, (xq - t1) / jnp.where(t1 == t2, 1.0, t2 - t1))
    a = (1.0 - b)[:, None]
    b = b[:, None]
    spec = a * jnp.take(S, floor_i, axis=0) + b * jnp.take(S, ceil_i, axis=0)
    per = a * jnp.take(PER, floor_i, axis=0) + b * jnp.take(PER, ceil_i, axis=0)
    aps = a * jnp.take(AP, floor_i, axis=0) + b * jnp.take(AP, ceil_i, axis=0)

    voiced = jnp.take(vuv_interp, pli - 1)
    if variant == "standard":  # synthesis_a has no aperiodicity gate
        voiced = voiced & (aps[:, 0] <= 0.999)

    # ---- periodic responses (synthesis.py:100-116), batched ---------------
    tmp = jnp.maximum(spec * per, jnp.finfo(dtype).eps)
    mp_spec = minimum_phase_spectrum(mirror_full(tmp))
    half = mp_spec[:, : fft_size // 2 + 1]
    ramp = jnp.exp(-1j * (coefficient * shifts)[:, None] * half_k[None, :])
    half = half * ramp
    full = jnp.concatenate([half, half[:, -2:0:-1].conj()], axis=1)
    response = jnp.fft.fftshift(jnp.fft.ifft(full).real, axes=-1)
    dc_remover = dc_base[None, :] * (-jnp.sum(response, axis=1, keepdims=True))
    periodic = (response + dc_remover) * jnp.sqrt(
        jnp.maximum(1.0, noise_sizes.astype(dtype)))[:, None]
    periodic = jnp.where(voiced[:, None], periodic, 0.0)

    # ---- aperiodic responses (synthesis.py:86-96), batched ----------------
    ap_spec = jnp.where(voiced[:, None], spec * aps, spec)
    ap_spec = jnp.maximum(ap_spec, jnp.finfo(dtype).eps)
    ap_response = jnp.fft.fftshift(
        jnp.fft.ifft(minimum_phase_spectrum(mirror_full(ap_spec))).real,
        axes=-1)
    n_noise = jnp.maximum(3, jnp.minimum(noise_sizes, max_noise))
    noise_mask = jnp.arange(max_noise)[None, :] < n_noise[:, None]
    if noise_mode == "constant":
        noise = jnp.where(noise_mask, 0.1, 0.0)
    else:
        noise = jnp.where(noise_mask,
                          jax.random.normal(key, (max_pulses, max_noise),
                                            dtype=dtype), 0.0)
    noise = jnp.where(noise_mask,
                      noise - jnp.sum(noise, axis=1, keepdims=True)
                      / n_noise[:, None], 0.0)
    # conv(noise, response)[:fft_size]  (fftfilt, synthesis.py:189-250)
    conv_n = 2 * fft_size
    ap_out = jnp.fft.irfft(jnp.fft.rfft(noise, conv_n)
                         * jnp.fft.rfft(ap_response, conv_n),
                         conv_n)[:, :fft_size]

    del k_overlap
    contributions = jnp.where(valid[:, None], periodic + ap_out, 0.0)
    starts = jnp.where(valid, pli - fft_size // 2,
                       y_length + fft_size + 2).astype(jnp.int32)
    from ..dsp.ola import slotted_ola

    return slotted_ola(contributions, starts, y_length, slot=32), \
        raw_count > max_pulses


def synthesis(source_object, filter_object, key=None, noise_mode="gaussian",
              max_pulses=None, variant="standard"):
    """Waveform synthesis (API mirrors synthesis.py:21-82).

    ``variant='a'`` reproduces the historical synthesis_a.py behavior
    (pi/2 pulse threshold, no fractional shift, no aperiodicity VUV gate;
    synthesis_a.py:59-116) — kept for completeness, not used by World.decode,
    matching the reference where it is dead code."""
    f0 = np.asarray(source_object["f0"], dtype=np.float64)
    vuv = np.asarray(source_object["vuv"], dtype=np.float64)
    tp = np.asarray(source_object["temporal_positions"], dtype=np.float64)
    spectrogram = jnp.asarray(filter_object["spectrogram"])
    aperiodicity = jnp.asarray(source_object["aperiodicity"])
    fs = int(filter_object["fs"])

    time_axis_len = len(np.arange(tp[0], tp[-1] + 1 / fs, 1.0 / fs))
    fft_size = (spectrogram.shape[0] - 1) * 2
    if max_pulses is None:
        est = int(np.ceil((tp[-1] - tp[0]) * max(500.0, float(f0.max()) * 1.2))) + 8
        max_pulses = int(2 ** np.ceil(np.log2(est)))
    max_noise = int(fs / 40) + 4
    if key is None:
        key = jax.random.PRNGKey(0)
    f0_hi = max(500.0, float(f0.max()) * 1.05)
    k_overlap = min(int(np.ceil(fft_size * f0_hi / fs / 8) + 1) * 8, max_pulses)
    from ..frames import uniform_frame_period_ms

    fp_ms = uniform_frame_period_ms(tp)
    fp_s = None if fp_ms is None else fp_ms / 1000.0

    y, pulse_overflow = _synthesis_core(
        jnp.asarray(f0, spectrogram.dtype),
        jnp.asarray(vuv, spectrogram.dtype), jnp.asarray(tp, spectrogram.dtype),
        spectrogram, aperiodicity, key, fs, time_axis_len, fft_size,
        max_pulses, max_noise, noise_mode, variant, k_overlap, fp_s)
    if bool(np.asarray(pulse_overflow)):
        import warnings

        warnings.warn(
            f"synthesis: pulse count exceeded max_pulses={max_pulses}; "
            f"trailing pulses were dropped — raise max_pulses",
            RuntimeWarning, stacklevel=2)
    return y


def synthesis_a(source_object, filter_object, key=None, noise_mode="gaussian",
                max_pulses=None):
    """The historical synthesis variant (synthesis_a.py:21-101)."""
    return synthesis(source_object, filter_object, key=key,
                     noise_mode=noise_mode, max_pulses=max_pulses, variant="a")
