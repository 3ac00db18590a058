"""Overlap-add without scatter-adds.

The synthesizers place ~10^3-10^4 windowed responses at irregular positions
(/root/reference/world/synthesis.py:67-81, synthesisRequiem.py:59-61,99-100).
Instead of a scatter-add (whose accumulation order is not fixed), each
OUTPUT sample gathers from the
(small, bounded) set of responses overlapping it: response start positions
are nondecreasing, so the overlapping set is a contiguous run of at most K
responses found with one binary search — K static, derived from the minimum
response spacing.
"""
import jax
import jax.numpy as jnp
import numpy as np

from .scanops import searchsorted_rows, shift_select_rows


def uniform_ola(resp, start0: int, hop: int, y_length: int):
    """Overlap-add of resp (F, W) at uniformly spaced starts start0 + f*hop.

    Pure shift-and-fold: split each response into hop-wide column chunks;
    chunk c of frame f lands in output block f + c.  No gathers/scatters.
    Out-of-range parts are dropped.
    """
    F, W = resp.shape
    n_chunks = -(-W // hop)
    pad_w = n_chunks * hop - W
    r = jnp.pad(resp, ((0, 0), (0, pad_w)))
    blocks = jnp.zeros((F + n_chunks, hop), resp.dtype)
    for c in range(n_chunks):
        blocks = blocks.at[c : c + F].add(r[:, c * hop : (c + 1) * hop])
    flat = blocks.reshape(-1)
    out = jnp.zeros(y_length, resp.dtype)
    # place flat at offset start0 (may be negative)
    lo = max(0, start0)
    src_lo = lo - start0
    n = min(y_length - lo, flat.shape[0] - src_lo)
    if n > 0:
        out = out.at[lo : lo + n].set(flat[src_lo : src_lo + n])
    return out


def slotted_ola(resp, starts, y_length: int, slot: int = 32):
    """Overlap-add of resp (P, W) at NONDECREASING integer ``starts`` when at
    most a few responses start within any ``slot``-wide window.

    Each response is shifted to its in-slot offset (radix select), responses
    are summed per slot with ONE one-hot matmul, and the slotted grid
    folds with :func:`uniform_ola`.  Multiple responses per slot are handled
    exactly (the matmul accumulates).  Invalid responses must carry starts
    >= y_length + W.
    """
    P, W = resp.shape
    base = slot * (-(-W // slot) + 1)          # cover starts down to -W
    n_slots = (y_length + base) // slot + 2
    sid = (starts + base) // slot
    off = starts - (sid * slot - base)         # in-slot offset in [0, slot)
    shifted = shift_select_rows(
        jnp.pad(resp, ((0, 0), (slot, 0))),    # room to shift right
        slot - off, slot, W + slot)            # shifted[p, off+j] = resp[p, j]
    sid = jnp.clip(sid, 0, n_slots)            # n_slots = trash slot
    s_ids = jnp.arange(n_slots + 1, dtype=sid.dtype)
    onehot = (s_ids[:, None] == sid[None, :]).astype(resp.dtype)
    # onehot is 0/1 (exactly bf16-representable): dot_exact_b reproduces the
    # full-f32 product with 3 bf16 dots — exact waveform samples (a DEFAULT
    # f32 dot here could run in reduced precision and put noise in the
    # output)
    from ..ops import dot_exact_b

    slotted = dot_exact_b(shifted.T, onehot.T).T[: n_slots]
    return uniform_ola(slotted, -base, slot, y_length)


def gather_ola(responses, starts, y_length: int, K: int):
    """y[i] = sum_p responses[p, i - starts[p]] over p with 0 <= i-starts[p] < W.

    responses: (P, W); starts: (P,) int32, NONDECREASING 0-based output
    positions (invalid/padded responses must carry starts >= y_length + W and
    zero content).  K bounds how many responses can overlap one sample;
    overflow beyond K is dropped (callers size K from the minimum possible
    response spacing).  Out-of-range parts of a response are dropped (the
    reference clamps them onto the edge samples; divergence limited to the
    first/last window).
    """
    P, W = responses.shape
    i = jnp.arange(y_length, dtype=jnp.int32)
    # first response index whose window can still cover sample i
    lo = searchsorted_rows(starts[None, :], (i - W + 1)[None, :],
                           side="left")[0]
    flat = responses.reshape(-1)
    acc = jnp.zeros(y_length, responses.dtype)
    for k in range(K):
        p = jnp.minimum(lo + k, P - 1)
        s = jnp.take(starts, p)
        off = i - s
        valid = (off >= 0) & (off < W) & (lo + k < P)
        idx = p * W + jnp.clip(off, 0, W - 1)
        acc = acc + jnp.where(valid, jnp.take(flat, idx), 0.0)
    return acc
