"""FIR filtering as im2col matmuls.

The reference implements its band filters as full-signal-length FFT products
(/root/reference/world/dio.py:87, harvest.py:259-261).  The filters are
short (<= ~500 taps), so the exact same linear convolution is an
(n, L) x (L, B) matmul over statically-sliced shifted copies of the signal.
"""
import jax
import jax.numpy as jnp
import numpy as np


def _im2col_conv(y_seg, bank, out_len: int):
    """(out_len, L) shifted-copy columns of ``y_seg`` @ bank.T -> (B, out_len).

    y_seg must already carry L-1 zeros of left padding and enough right
    padding that every slice is in range.
    """
    L = bank.shape[1]
    cols = jnp.stack([y_seg[L - 1 - j : L - 1 - j + out_len]
                      for j in range(L)], axis=1)
    # HIGHEST: under vmap XLA otherwise picks a reduced-precision batched
    # matmul (measured 2e-2 drift vs the single-stream result, which
    # perturbs zero-crossing times and cascades into the F0 candidates)
    return jnp.einsum("kj,bj->bk", cols, bank,
                      preferred_element_type=y_seg.dtype,
                      precision=jax.lax.Precision.HIGHEST)


def fir_bank_full(y, bank, block: int = None):
    """Full linear convolution of ``y`` with every row of ``bank``.

    y: (n,); bank: (B, L) [host or device].  Returns (B, n+L-1) with
    out[b, k] = sum_j bank[b, j] * y[k - j]  — identical to the reference's
    zero-padded FFT products on their linear-convolution support
    (/root/reference/world/harvest.py:259-261).

    ``block``: if set, run as blocked overlap-add (a lax.scan over
    ``block``-sample chunks carrying the L-1 tail) instead of one im2col.
    The single-shot path materializes an (n+L-1, L) column matrix —
    quadratic-ish memory pressure at minutes of audio; the blocked path
    bounds live memory at O(block*L) while producing bit-identical sums of
    the same products per output sample (each product lands in exactly one
    chunk's einsum; only the carry-add ordering differs, which is exact in
    the f64 golden path and below mask tolerance in f32).
    """
    y = jnp.asarray(y)
    bank = jnp.asarray(bank, dtype=y.dtype)
    n = y.shape[0]
    B, L = bank.shape
    if block is None or n <= block:
        ypad = jnp.pad(y, (L - 1, L - 1))
        return _im2col_conv(ypad, bank, n + L - 1)

    n_chunks = -(-n // block)
    y2 = jnp.pad(y, (0, n_chunks * block - n)).reshape(n_chunks, block)

    def body(carry, yc):
        seg = jnp.pad(yc, (L - 1, L - 1))
        conv = _im2col_conv(seg, bank, block + L - 1)   # (B, block+L-1)
        out = conv[:, :block].at[:, : L - 1].add(carry)
        return conv[:, block:], out

    tail, outs = jax.lax.scan(body, jnp.zeros((B, L - 1), y.dtype), y2)
    full = jnp.concatenate(
        [jnp.transpose(outs, (1, 0, 2)).reshape(B, n_chunks * block), tail],
        axis=1)
    return full[:, : n + L - 1]
