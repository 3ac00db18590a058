"""Scan/search primitives built from compares, scans and flat gathers.

  * compensated_cumsum: a double-word prefix sum, for windowed sums that
    must keep their precision next to a large running total.
  * searchsorted_rows: batched binary search with statically-unrolled steps
    and FLAT 1-D gathers (arbitrary 1-D gathers are fast; take_along_axis
    and lax.scan-based searches are not).
"""
import jax
import jax.numpy as jnp
import numpy as np


def _two_sum(a, b):
    """s + e == a + b exactly, s = fl(a + b) (Knuth's TwoSum)."""
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def compensated_cumsum(x):
    """Inclusive cumsum along the last axis as an unevaluated sum hi + lo.

    A TwoSum-compensated associative scan: hi is the rounded running sum and
    lo carries its rounding error, so hi + lo holds ~twice the working
    precision.  Windowed sums taken as differences of it,
    ``(hi[b] - hi[a]) + (lo[b] - lo[a])``, are then accurate relative to the
    WINDOW, not to the running total — which a plain float32 cumsum over a
    spectrum with ~90 dB of dynamic range is not."""
    def combine(a, b):
        s, e = _two_sum(a[0], b[0])
        return s, a[1] + b[1] + e

    return jax.lax.associative_scan(combine, (x, jnp.zeros_like(x)),
                                    axis=x.ndim - 1)


def searchsorted_rows(a, v, side: str = "left", n_steps: int = None):
    """Row-wise searchsorted: a (R, N) sorted rows, v (R, Q) or (Q,) queries.

    Returns (R, Q) insertion indices, identical to
    vmap(jnp.searchsorted)(a, v) but via an unrolled binary search with flat
    gathers.
    """
    a = jnp.asarray(a)
    v = jnp.asarray(v)
    R, N = a.shape
    if v.ndim == 1:
        v = jnp.broadcast_to(v[None, :], (R, v.shape[0]))
    flat = a.reshape(-1)
    row_off = (jnp.arange(R) * N)[:, None]
    if n_steps is None:
        n_steps = int(np.ceil(np.log2(N + 1)))
    lo = jnp.zeros(v.shape, jnp.int32)           # lower bound (insertion >= lo)
    hi = jnp.full(v.shape, N, jnp.int32)         # upper bound
    for _ in range(n_steps):
        mid = (lo + hi) // 2
        am = jnp.take(flat, row_off + jnp.minimum(mid, N - 1))
        go_right = (am < v) if side == "left" else (am <= v)
        go_right = go_right & (mid < hi)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, jnp.minimum(mid, hi))
    return lo


def count_less_rows(a, q, side: str = "left"):
    """Row-wise searchsorted for SHORT rows via a compare-reduce.

    a: (R, N) sorted rows with small N; q: (Q,) or (R, Q) queries.  Counting
    elements < q (or <= q for side='right') costs R*N*Q fused compares,
    which replaces a binary-search gather when N is small.
    """
    a = jnp.asarray(a)
    q = jnp.asarray(q)
    if q.ndim == 1:
        q = q[None, :]
    if side == "left":
        hits = a[:, :, None] < q[:, None, :]
    else:
        hits = a[:, :, None] <= q[:, None, :]
    return jnp.sum(hits, axis=1).astype(jnp.int32)


def shift_select_rows(slab, shift, max_shift: int, width: int, radix: int = 16):
    """out[r, j] = slab[r, shift[r] + j] for per-row integer shifts in
    [0, max_shift], via a two-level radix select over static slices (no
    per-row gather).

    slab: (R, W) with W >= max_shift + width.
    """
    n_coarse = (max_shift // radix) + 1
    coarse = shift // radix
    fine = shift - coarse * radix
    mid_w = width + radix - 1
    need = (n_coarse - 1) * radix + mid_w
    if need > slab.shape[1]:
        slab = jnp.pad(slab, ((0, 0), (0, need - slab.shape[1])))
    out = slab[:, 0:mid_w]
    for c in range(1, n_coarse):
        sel = (coarse == c)[:, None]
        out = jnp.where(sel, slab[:, c * radix : c * radix + mid_w], out)
    res = out[:, 0:width]
    for fshift in range(1, radix):
        sel = (fine == fshift)[:, None]
        res = jnp.where(sel, out[:, fshift : fshift + width], res)
    return res


def select_rows_small(y, idx):
    """take_along_axis(y, idx, axis=-1) via an equality-masked sum.

    y: (..., N); idx: (..., Q) int32.  Gather-free: costs N*Q fused
    compare-select-adds per row, meant for small N (<= a few thousand).
    Exact (no arithmetic on y).
    """
    y = jnp.asarray(y)
    n = y.shape[-1]
    k = jnp.arange(n, dtype=jnp.int32)
    onehot = idx[..., :, None] == k  # (..., Q, N), fused into the reduce
    return jnp.sum(jnp.where(onehot, y[..., None, :], 0), axis=-1)


def take_rows(y, idx):
    """take_along_axis(y, idx, axis=-1) via a flat 1-D gather.

    y: (..., N); idx: (..., Q) int32 indices into the last axis.
    """
    y = jnp.asarray(y)
    n = y.shape[-1]
    lead = y.shape[:-1]
    flat = y.reshape(-1)
    row_off = (jnp.arange(int(np.prod(lead))) * n).reshape(lead)[..., None]
    return jnp.take(flat, row_off + idx)
