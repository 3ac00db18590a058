"""The WORLD low-frequency mirror fill, gather-free.

Both CheapTrick (cheaptrick.py:64-75) and D4C (d4c.py:213-222) add a
mirrored low-frequency replica: replica(f) = interp of the spectrum at
(f0 - f) with end-segment extrapolation, added to bins below f0.  On a
uniform bin grid the read positions are k + alpha with a per-frame constant
alpha, so the whole thing is a per-row fractional shift of the REVERSED
low-band slice — realized with radix shift-selects and two static boundary
patches, no gathers.
"""
import jax.numpy as jnp

from .scanops import shift_select_rows


def dc_fill_add(signal_half, f0, fs, fft_size: int, boundary_factor: float,
                KL: int, dtype):
    """Returns signal_half + replica on bins < f0.

    in_low set: bins with freq < boundary (boundary = f0 + df for CheapTrick
    [boundary_factor=None sentinel via exact value], 1.2*f0 for D4C) — the
    caller passes ``boundary_factor`` so that boundary = f0*boundary_factor
    + (df if boundary_factor == 1.0 else 0).  KL is the static low-band
    width (must cover boundary/df + 2 for all expected f0).
    """
    df = fs / fft_size
    kmax = signal_half.shape[-1]
    KL = min(kmax, KL)
    k = jnp.arange(KL, dtype=dtype)[None, :]
    freqs = k * df
    f0c = f0[:, None]
    if boundary_factor == 1.0:
        boundary = f0c + df
    else:
        boundary = boundary_factor * f0c
    in_low = freqs < boundary
    m = jnp.minimum(jnp.sum(in_low, axis=1), KL)            # (F,)
    y_src = jnp.where(in_low, signal_half[:, :KL], 0.0)

    # read positions: pos = k + alpha, alpha = (m-1) - f0/df  (>= 0)
    alpha = (m - 1).astype(dtype) - f0 / df
    a_f = jnp.floor(alpha).astype(jnp.int32)
    frac_a = alpha - a_f

    # y_asc[j] = y_src[m-1-j]; z[k] = y_asc[k + a_f] = g[(KL-m) + k + a_f]
    g = y_src[:, ::-1]
    gpad = jnp.pad(g, ((0, 0), (0, KL + KL // 2 + 4)))
    sh = jnp.clip(KL - m + a_f, 0, KL + KL // 2)
    z = shift_select_rows(gpad, sh, KL + KL // 2, KL + 1)
    y0u = z[:, :KL]
    y1u = z[:, 1:KL + 1]

    base_u = jnp.arange(KL, dtype=jnp.int32)[None, :] + a_f[:, None]
    hi = (m - 2)[:, None].astype(jnp.int32)
    clipped = base_u > hi
    # y_asc[m-2] == y_src[1], y_asc[m-1] == y_src[0] — static reads
    y0 = jnp.where(clipped, y_src[:, 1:2], y0u)
    y1 = jnp.where(clipped, y_src[:, 0:1], y1u)
    pos = k + alpha[:, None]
    frac = pos - jnp.minimum(base_u, hi).astype(dtype)
    replica = y0 + (y1 - y0) * frac
    add = jnp.where(freqs < f0c, replica, 0.0)
    return signal_half + jnp.pad(add, ((0, 0), (0, kmax - KL)))
