"""Zero-crossing interval extraction with fixed-capacity compaction.

The reference's ZeroCrossingEngine (/root/reference/world/dio.py:190-204,
harvest.py:283-297) is a numba loop producing ragged event lists.  Here the
crossing mask is compacted into a static-capacity buffer with a cumsum +
scatter (O(n), fully parallel); downstream consumers carry a valid count.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp


class Events(NamedTuple):
    locations: jnp.ndarray  # (capacity,) interval midpoints in seconds
    f0: jnp.ndarray         # (capacity,) interval-based instantaneous f0
    count: jnp.ndarray      # scalar int: number of valid intervals


def zero_crossing_events(x, fs, capacity: int) -> Events:
    """Negative-going zero crossings of ``x`` -> interval locations & f0.

    Matches the reference bit-for-bit (same 1-based sub-sample edge formula);
    events beyond ``capacity`` are dropped (callers size capacity from the
    band's maximum possible crossing rate).
    """
    x = jnp.asarray(x)
    n = x.shape[0]
    x_next = jnp.concatenate([x[1:], x[-1:]])
    mask = (x_next * x < 0) & (x_next < x)
    # 1-based index of the sample *after* the crossing, with fractional part
    idx1 = jnp.arange(1, n + 1, dtype=x.dtype)
    denom = x_next - x
    fine = idx1 - x / jnp.where(denom == 0, 1.0, denom)
    # scatter-free compaction: the j-th event's position is the first index
    # where cumsum(mask) reaches j+1 — a batched binary search (gathers only,
    # no scatter or sort)
    c = jnp.cumsum(mask.astype(jnp.int32))
    sel = jnp.searchsorted(c, jnp.arange(1, capacity + 2, dtype=jnp.int32),
                           side="left")
    n_edges = jnp.minimum(c[-1], capacity + 1)
    in_range = jnp.arange(capacity + 1) < n_edges
    edges = jnp.where(in_range, jnp.take(fine, jnp.minimum(sel, n - 1)), 0.0)
    locations = (edges[:-1] + edges[1:]) / 2.0 / fs
    diffs = edges[1:] - edges[:-1]
    f0 = fs / jnp.where(diffs == 0, 1.0, diffs)
    count = jnp.maximum(n_edges - 1, 0)
    valid = jnp.arange(capacity) < count
    return Events(jnp.where(valid, locations, 0.0), jnp.where(valid, f0, 0.0), count)
