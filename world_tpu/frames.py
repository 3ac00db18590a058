"""Fixed-shape framing: F0-adaptive windowed segments as batched gathers.

The reference gathers a data-dependent-length segment per frame inside Python
loops (e.g. /root/reference/world/cheaptrick.py:79-99, d4c.py:92-110).  Here
every frame gathers a static MAXLEN slab centered on its 1-based anchor index
and applies a validity mask; one vmap/batched gather replaces all loops.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from .dsp.rounding import round_matlab



def _adaptive_window_values(time_axis, f0, window_type: str):
    """Hann/Blackman values at time_axis*f0.  In f32 both cosines use the
    range-reduced polynomial (ops.cos_reduced, f32-cos-grade 1.8e-7 error at
    ~16 VPU ops); f64 keeps the reference's two-cos form bit-for-bit."""
    arg = jnp.pi * time_axis * f0
    if arg.dtype == jnp.float32:
        # |arg| <= ~pi inside the window mask (2*arg <= ~2.2*pi for the
        # Blackman second cosine — inside cos_reduced's reduction range);
        # masked lanes tolerate out-of-range garbage
        from .ops import cos_reduced
        c1 = cos_reduced(arg)
    else:
        c1 = jnp.cos(arg)
    if window_type == "hanning":
        return 0.5 * c1 + 0.5
    if window_type != "blackman":
        raise ValueError(window_type)
    if arg.dtype == jnp.float32:
        c2 = cos_reduced(2 * arg)
    else:
        c2 = jnp.cos(2 * arg)
    return 0.08 * c2 + 0.5 * c1 + 0.42


def uniform_frame_period_ms(temporal_positions):
    """Frame period in ms if temporal_positions is the standard uniform grid
    (arange * fp / 1000, in its own dtype), else None (slower gather paths
    are used then).  A float32 grid's first step is 4.99999988 ms for a
    5 ms period, so the period is rounded before the grid is rebuilt."""
    tp = np.asarray(temporal_positions)
    if tp.ndim != 1 or tp.shape[0] < 3:
        return None
    fp_ms = round(float(tp[1] - tp[0]) * 1000.0, 6)
    if fp_ms <= 0:
        return None
    grid = (np.arange(tp.shape[0]) * fp_ms / 1000.0).astype(tp.dtype)
    tol = 4 * np.finfo(tp.dtype).eps * max(1.0, float(np.abs(tp).max()))
    if np.allclose(tp, grid, rtol=0, atol=tol):
        return fp_ms
    return None


def uniform_frames(x, stride_samples: float, n_frames: int, width: int,
                   rel_start: int):
    """Extract (n_frames, width) slabs slab[q, j] = x_clamped[r(q)+rel_start+j]
    with r(q) = floor(q * stride) — evaluated EXACTLY on the rational stride —
    using only pads and strided patch extraction (no gathers).

    Index clamping to the signal bounds is realized by edge-padding, which is
    exactly the reference's min/max index clamp (e.g. cheaptrick.py:90-91).
    """
    from jax import lax

    n = x.shape[-1]
    frac = Fraction(stride_samples).limit_denominator(1000)
    pnum, qden = frac.numerator, frac.denominator
    a_count = (n_frames + qden - 1) // qden + 1
    pl = max(0, -rel_start) + 4
    pr = max(0, (a_count - 1) * pnum + pnum + rel_start + width + 8 - n)
    xpad = jnp.pad(x, (pl, pr), mode="edge")
    outs = []
    for bres in range(qden):
        c_b = (bres * pnum) // qden
        s = pl + c_b + rel_start
        seg = xpad[s : s + (a_count - 1) * pnum + width]
        # precision=HIGHEST: an identity convolution at reduced precision
        # would quantize the signal itself, and every windowed analysis
        # stage (Harvest's candidate scores above all) inherits that noise;
        # at HIGHEST the extraction is exact (precision rule, __init__.py)
        p = lax.conv_general_dilated_patches(
            seg[None, None, :], (width,), (pnum,), "VALID",
            precision=lax.Precision.HIGHEST)                  # (1, width, a)
        outs.append(p[0].T)                                   # (a, width)
    grid = jnp.stack(outs, axis=1)                            # (a, qden, width)
    return grid.reshape(-1, width)[:n_frames]


def uniform_centered_slabs(x, fs: float, frame_period_s: float, n_frames: int,
                           temporal_positions, max_half: int, margin: int = 0):
    """(n_frames, 2*max_half+1+2*margin) slabs centered on the reference's
    per-frame anchor center(q) = floor(t_q*fs + 0.501) + 1 (1-based), i.e.
    0-based window start center-1-max_half-margin, robust to ±1 fp slop via a
    4-way shift select.  Returns (slabs, d) where d is the extra data-driven
    shift budget used: callers read window j at slab[:, j + margin]."""
    stride = fs * frame_period_s
    width0 = 2 * max_half + 1 + 2 * margin
    slab = uniform_frames(x, stride, n_frames, width0 + 3,
                          -max_half - margin - 1)
    # exact rational grid on host: T(q) = q*pnum/qden, center = floor(T+0.501)+1
    # computed in integer arithmetic.  The previous device-f32 center
    # (floor(t*fs + 0.501)) rounds t*fs at ~5e4 magnitude (ulp ~4e-3), so
    # frames whose true fractional part sits within an ulp of the .501
    # boundary gathered a NEIGHBORING sample on one backend and not the
    # other — a whole-sample segment shift that flipped downstream candidate
    # argmaxes.  Integer center makes the gather bitwise deterministic and
    # matches the reference's f64 round_matlab(t*fs + 0.001) exactly (the
    # grid fractions are >=1e-3 away from the .499 boundary).
    frac = Fraction(stride).limit_denominator(1000)
    pnum, qden = frac.numerator, frac.denominator
    q = np.arange(n_frames, dtype=np.int64)
    r = (q * pnum) // qden
    center_i = (1000 * q * pnum + 501 * qden) // (1000 * qden) + 1
    d = jnp.asarray(np.clip(center_i - r, 0, 3).astype(np.int32))
    out = jnp.where((d == 0)[:, None], slab[:, 0:width0], 0.0)
    for dd in range(1, 4):
        out = jnp.where((d == dd)[:, None], slab[:, dd : dd + width0], out)
    return out


def gather_1based(x, index_float_1based):
    """x[min(len, max(1, round(idx))) - 1] — the reference's safe gather."""
    safe = jnp.clip(round_matlab(index_float_1based), 1, x.shape[0]).astype(jnp.int32)
    return jnp.take(x, safe - 1)


def gather_trunc_1based(x, index_float_1based):
    """x[int(min(len, max(1, idx))) - 1]: clamp then truncate (no rounding).

    Matches sites where the reference astype(int)s an already-half-offset
    float index (stonemask.py:48-50, harvest.py:189)."""
    safe = jnp.clip(index_float_1based, 1, x.shape[0]).astype(jnp.int32)
    return jnp.take(x, safe - 1)


def windowed_segment(x, fs, f0, temporal_position, half_length, max_half: int,
                     window_type: str, sub_sample_shift: bool,
                     normalize_window: bool = False):
    """Windowed waveform of length 2*half+1 (half = int(half_length*fs/f0+0.5))
    padded into a static 2*max_half+1 buffer, window applied, weighted-mean
    removed — matching d4c.get_windowed_waveform (d4c.py:92-110) when
    ``sub_sample_shift`` and cheaptrick.calculate_windowed_waveform
    (cheaptrick.py:79-99) when not (cheaptrick divides time axis by
    half_length instead of adding the fractional shift).

    Returns (waveform, mask) both of shape (2*max_half+1,); entries outside
    the true window are exactly zero.
    """
    half = jnp.floor(half_length * fs / f0 + 0.5)  # == int(.) for positive
    base_index = jnp.arange(-max_half, max_half + 1, dtype=x.dtype)
    mask = jnp.abs(base_index) <= half
    center = jnp.floor(temporal_position * fs + 0.501) + 1.0
    segment = gather_1based(x, center + base_index) * mask

    if sub_sample_shift:
        frac = (temporal_position * fs
                - jnp.floor(temporal_position * fs + 0.5)) / fs
        time_axis = base_index / fs / half_length + frac
    else:
        time_axis = base_index / fs / half_length

    window = _adaptive_window_values(time_axis, f0, window_type)
    window = jnp.where(mask, window, 0.0)
    if normalize_window:
        window = window / jnp.sqrt(jnp.sum(window ** 2))

    sw = segment * window
    waveform = sw - window * (jnp.sum(sw) / jnp.sum(window))
    return jnp.where(mask, waveform, 0.0), mask, window


def apply_adaptive_window(segment, fs, f0, temporal_position, half_length,
                          max_half: int, window_type: str,
                          sub_sample_shift: bool,
                          normalize_window: bool = False):
    """F0-adaptive windowing + weighted-mean removal on pre-gathered
    segments (F, 2*max_half+1) aligned to base_index = -max_half..max_half."""
    x_dtype = segment.dtype
    f0 = f0[:, None]
    t = temporal_position[:, None]
    half = jnp.floor(half_length * fs / f0 + 0.5)
    base_index = jnp.arange(-max_half, max_half + 1, dtype=x_dtype)[None, :]
    mask = jnp.abs(base_index) <= half
    segment = segment * mask

    if sub_sample_shift:
        frac = (t * fs - jnp.floor(t * fs + 0.5)) / fs
        time_axis = base_index / fs / half_length + frac
    else:
        time_axis = jnp.broadcast_to(base_index / fs / half_length, mask.shape)

    window = _adaptive_window_values(time_axis, f0, window_type)
    window = jnp.where(mask, window, 0.0)
    if normalize_window:
        window = window / jnp.sqrt(jnp.sum(window ** 2, axis=1, keepdims=True))

    sw = segment * window
    waveform = sw - window * (jnp.sum(sw, axis=1, keepdims=True)
                              / jnp.sum(window, axis=1, keepdims=True))
    return jnp.where(mask, waveform, 0.0), mask, window


def windowed_segment_batch(x, fs, f0, temporal_position, half_length,
                           max_half: int, window_type: str,
                           sub_sample_shift: bool,
                           normalize_window: bool = False):
    """Batched :func:`windowed_segment`: f0/temporal_position are (F,) and
    all outputs are (F, 2*max_half+1).

    Written batched (not vmapped) so the signal gather lowers to ONE flat
    1-D-operand gather instead of vmap's batched-operand form.
    """
    f0 = f0[:, None]
    t = temporal_position[:, None]
    half = jnp.floor(half_length * fs / f0 + 0.5)
    base_index = jnp.arange(-max_half, max_half + 1, dtype=x.dtype)[None, :]
    mask = jnp.abs(base_index) <= half
    center = jnp.floor(t * fs + 0.501) + 1.0
    safe = jnp.clip(round_matlab(center + base_index), 1, x.shape[0]).astype(jnp.int32)
    segment = jnp.take(x, safe - 1) * mask

    if sub_sample_shift:
        frac = (t * fs - jnp.floor(t * fs + 0.5)) / fs
        time_axis = base_index / fs / half_length + frac
    else:
        time_axis = jnp.broadcast_to(base_index / fs / half_length,
                                     mask.shape)

    window = _adaptive_window_values(time_axis, f0, window_type)
    window = jnp.where(mask, window, 0.0)
    if normalize_window:
        window = window / jnp.sqrt(jnp.sum(window ** 2, axis=1, keepdims=True))

    sw = segment * window
    waveform = sw - window * (jnp.sum(sw, axis=1, keepdims=True)
                              / jnp.sum(window, axis=1, keepdims=True))
    return jnp.where(mask, waveform, 0.0), mask, window
