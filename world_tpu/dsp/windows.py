"""Window functions (MATLAB conventions), built as jnp expressions.

Replaces the per-module copies in the reference
(nuttall: /root/reference/world/dio.py:208-212, harvest.py:563-567,
d4c.py:237-245; hanning: scipy.signal.hanning call sites).
All are symmetric windows with endpoints included (MATLAB ``hanning(N)``
corresponds to ``hann(N+2)[1:-1]`` here).
"""
import jax
import jax.numpy as jnp
import numpy as np


def np_nuttall(n: int) -> np.ndarray:
    """Host-side (trace-time constant) Nuttall window.

    NB: the argument is evaluated as arange(n) * 2 * pi / (n-1) in that exact
    order — for even n the two center samples tie in exact arithmetic and the
    dio band filters take an argmax over this window, so the fp rounding
    order matters for bit-parity.
    """
    t = np.arange(n) * 2 * np.pi / (n - 1)
    coefs = np.array([0.355768, -0.487396, 0.144232, -0.012604])
    return coefs @ np.cos(np.arange(4)[:, None] * t[None, :])


def np_hanning_matlab(n: int) -> np.ndarray:
    """Host-side MATLAB hanning(n) (no zero endpoints)."""
    i = np.arange(1, n + 1)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n + 1))


def nuttall(n: int, dtype=jnp.float64):
    """Nuttall window ('minimum 4-term Blackman-Harris', Nuttall 1981)."""
    t = jnp.arange(n, dtype=dtype) * 2 * jnp.pi / (n - 1)
    coefs = jnp.asarray([0.355768, -0.487396, 0.144232, -0.012604], dtype=dtype)
    k = jnp.arange(4, dtype=dtype)
    return jnp.einsum("c,ct->t", coefs, jnp.cos(k[:, None] * t[None, :]),
                      precision=jax.lax.Precision.HIGHEST)


def nuttall_masked(n_valid, max_len: int, dtype=jnp.float64):
    """Nuttall window of data-dependent length ``n_valid`` padded to max_len.

    Entries at index >= n_valid are zero.  ``n_valid`` may be a traced scalar;
    the output shape is static.  Used for the per-band filters of dio/harvest
    whose length depends on the band's boundary frequency.
    """
    idx = jnp.arange(max_len, dtype=dtype)
    t = idx * (2.0 * jnp.pi / (n_valid - 1))
    coefs = jnp.asarray([0.355768, -0.487396, 0.144232, -0.012604], dtype=dtype)
    k = jnp.arange(4, dtype=dtype)
    w = jnp.einsum("c,ct->t", coefs, jnp.cos(k[:, None] * t[None, :]),
                   precision=jax.lax.Precision.HIGHEST)
    return jnp.where(idx < n_valid, w, 0.0)


def hanning_matlab(n: int, dtype=jnp.float64):
    """MATLAB hanning(n): no zero endpoints (== scipy hann(n+2)[1:-1])."""
    i = jnp.arange(1, n + 1, dtype=dtype)
    return 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * i / (n + 1))


def hann_numpy(n: int, dtype=jnp.float64):
    """numpy.hanning / scipy hann: zero endpoints, 0.5-0.5cos(2 pi k/(n-1))."""
    k = jnp.arange(n, dtype=dtype)
    return 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * k / (n - 1))
