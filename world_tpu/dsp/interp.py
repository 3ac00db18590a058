"""Linear interpolation primitives (fixed-shape, mask-aware).

Fixed-shape replacements for the reference's scipy.interp1d calls
(fill_value='extrapolate', e.g. /root/reference/world/dio.py:167-179) and the
uniform-grid fast path ``interp1H`` (/root/reference/world/cheaptrick.py:122-131,
d4c.py:226-233).  Ragged event lists are handled by passing a ``valid_count``
and padding; everything stays statically shaped.
"""
import jax.numpy as jnp


def interp1_extrap(xp, fp, xq, valid_count=None):
    """Linear interp on ascending ``xp`` with end-segment linear extrapolation.

    Matches scipy ``interp1d(xp, fp, fill_value='extrapolate')`` for ascending
    xp.  ``valid_count`` (traced or static scalar) marks how many leading
    entries of xp/fp are real; padded entries are ignored.  Requires
    valid_count >= 2 for a meaningful result (caller guards otherwise).
    """
    xp = jnp.asarray(xp)
    fp = jnp.asarray(fp)
    n = xp.shape[-1]
    m = n if valid_count is None else valid_count
    idx = jnp.arange(n)
    xp_eff = jnp.where(idx < m, xp, jnp.inf)
    j = jnp.searchsorted(xp_eff, xq, side="right") - 1
    j = jnp.clip(j, 0, m - 2)
    x0 = jnp.take(xp, j)
    x1 = jnp.take(xp, j + 1)
    y0 = jnp.take(fp, j)
    y1 = jnp.take(fp, j + 1)
    denom = x1 - x0
    slope = (y1 - y0) / jnp.where(denom == 0, 1.0, denom)
    return y0 + slope * (xq - x0)


def interp1_sorted_descending_extrap(xp_desc, fp, xq, valid_count=None):
    """Like :func:`interp1_extrap` but xp is strictly descending.

    scipy's interp1d sorts its inputs (assume_sorted=False default); the
    reference relies on this for the mirrored low-frequency replica in
    dc-correction (/root/reference/world/cheaptrick.py:69, d4c.py:216).
    Implemented by flipping, which preserves exact arithmetic.
    """
    return interp1_extrap(
        xp_desc[..., ::-1], fp[..., ::-1], xq,
        valid_count=None if valid_count is None else valid_count,
    )


def interp1h_uniform(x0, dx, y, xi, last_x):
    """interp1H: uniform-grid linear interp with edge clamping.

    ``y`` is sampled at x0 + k*dx for k=0..n-1; queries are clamped to
    [x0, last_x] first (reference clamps to x[-1] == last grid point).
    The final grid point's forward-difference is defined as 0
    (/root/reference/world/cheaptrick.py:127-129).
    """
    y = jnp.asarray(y)
    n = y.shape[-1]
    xi = jnp.maximum(x0, jnp.minimum(last_x, xi))
    pos = (xi - x0) / dx
    base = jnp.floor(pos)
    frac = pos - base
    base_i = jnp.clip(base.astype(jnp.int32), 0, n - 1)
    next_i = jnp.minimum(base_i + 1, n - 1)
    if y.ndim > 1:
        from .scanops import take_rows  # flat 1-D gather

        y_b = take_rows(y, base_i)
        y_n = take_rows(y, next_i)
    else:
        y_b = jnp.take(y, base_i)
        y_n = jnp.take(y, next_i)
    delta = jnp.where(base_i >= n - 1, 0.0, y_n - y_b)
    return y_b + delta * frac
