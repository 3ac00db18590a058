"""IIR filtering as parallel linear recurrences (associative scan).

The reference runs its recursive filters as per-sample Python/numba loops
(hand-rolled decimator /root/reference/world/dio.py:359-476, cheby1 filtfilt
/root/reference/world/harvest.py:584-609, zero-phase biquad SmoothF0
/root/reference/world/harvest.py:533-559).  A per-sample loop is the worst
possible accelerator program; instead every IIR here is expressed as the linear
state recurrence  s_t = A s_{t-1} + B x_t  and evaluated with
``lax.associative_scan`` — O(n) work at O(log n) depth, fully on-device,
bit-for-bit the same recurrence.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def linear_recurrence(A, bx, s0=None):
    """Evaluate s_t = A @ s_{t-1} + bx[t] for t=0..n-1; returns all s_t.

    A: (k, k) constant matrix; bx: (..., n, k) forcing terms (scan along -2).
    s0: optional (..., k) initial state (defaults to zeros).

    The associative-scan elements are kept as k*k+k SEPARATE (..., n) arrays
    (scan axis minor-most) rather than packing the tiny state dims into
    trailing matrix dims, which tiled layouts would pad.

    Reproducibility (the root cause of batched-vs-single-stream f0 decision
    noise): the compiler is free to contract mul+add chains into FMAs, and
    where it does depends on the program's RANK and fusion context.
    Measured on the CPU in f32 with the real cheby1 coefficients: the (n,)
    and vmapped (B, n) programs drift ~1 ulp starting a few samples in,
    while (1, n) / (3, n) / (4, n) runs of the SAME rank are bitwise
    identical per row.  Two rejected schemes: a lax.map row fold and
    barrier-per-compose-product each re-introduced divergence (different
    compile context / blocked constant folding).  The fix is therefore
    rank canonicalization: every call flattens its lead dims to ONE row
    axis, runs the scan at rank 2, and a ``custom_vmap`` rule folds a
    vmapped batch axis into that same row axis — so the single-stream and
    batched programs are literally the same program with different row
    counts (asserted by tests/test_batched_bitwise.py on the CPU and by
    chip_smoke.py's batched-row bars on the GPU).
    """
    bx = jnp.asarray(bx)
    n, k = bx.shape[-2], bx.shape[-1]
    lead = bx.shape[:-2]
    A = jnp.asarray(A, bx.dtype)
    bx2 = bx.reshape((-1, n, k))
    if s0 is None:
        out = _linrec_cv(A, bx2)
    else:
        s0_2 = jnp.asarray(s0, bx.dtype).reshape((-1, k))
        out = _linrec_cv_s0(A, bx2, s0_2)
    return out.reshape(lead + (n, k))


def _linear_recurrence_impl(A, bx, s0=None):
    n, k = bx.shape[-2], bx.shape[-1]
    lead = bx.shape[:-2]

    a_elems = tuple(jnp.broadcast_to(A[i, j], lead + (n,))
                    for i in range(k) for j in range(k))
    b_elems = tuple(bx[..., i] for i in range(k))

    def compose(left, right):
        a1 = left[: k * k]
        b1 = left[k * k :]
        a2 = right[: k * k]
        b2 = right[k * k :]
        a_out = tuple(
            sum(a2[i * k + m] * a1[m * k + j] for m in range(k))
            for i in range(k) for j in range(k))
        b_out = tuple(
            sum(a2[i * k + m] * b1[m] for m in range(k)) + b2[i]
            for i in range(k))
        return a_out + b_out

    out = lax.associative_scan(compose, a_elems + b_elems, axis=bx.ndim - 2)
    afull = out[: k * k]
    bfull = out[k * k :]
    if s0 is not None:
        bfull = tuple(
            bfull[i] + sum(_nofma(afull[i * k + j], s0[..., j, None])
                           for j in range(k))
            for i in range(k))
    return jnp.stack(bfull, axis=-1)


from jax.custom_batching import custom_vmap  # noqa: E402


def _linrec_fold_rule(fn, axis_size, in_batched, A, *rest):
    """custom_vmap rule: run each batch element through the SAME program the
    single-stream call compiles (unrolled — scan codegen, and hence FMA
    placement, depends on the row count L, so batch rows must execute at the
    single-stream L, not at L*B).  The unroll makes compile time linear in
    the batch axis size; fine at serving batches (<=16 tested), but a very
    large vmapped batch pays a long trace."""
    if in_batched[0]:  # per-row A matrices never occur here (static coeffs)
        raise NotImplementedError("vmap over filter coefficients")

    def pick(a, batched, i):
        return a[i] if batched else a

    outs = [fn(A, *[pick(a, b, i) for a, b in zip(rest, in_batched[1:])])
            for i in range(axis_size)]
    return jnp.stack(outs), True


@custom_vmap
def _linrec_cv(A, bx):
    # entry/exit barriers: fusion from surrounding (possibly batched-rank)
    # producers/consumers must not leak into the scan region's codegen,
    # or contraction decisions there become batch-shape-dependent again
    return lax.optimization_barrier(
        _linear_recurrence_impl(A, lax.optimization_barrier(bx), None))


@_linrec_cv.def_vmap
def _linrec_cv_rule(axis_size, in_batched, A, bx):
    return _linrec_fold_rule(_linrec_cv, axis_size, in_batched, A, bx)


@custom_vmap
def _linrec_cv_s0(A, bx, s0):
    bx, s0 = lax.optimization_barrier((bx, s0))
    return lax.optimization_barrier(_linear_recurrence_impl(A, bx, s0))


@_linrec_cv_s0.def_vmap
def _linrec_cv_s0_rule(axis_size, in_batched, A, bx, s0):
    return _linrec_fold_rule(_linrec_cv_s0, axis_size, in_batched, A, bx, s0)


@functools.lru_cache(maxsize=None)
def _trunc_impulse(b, a):
    """Truncated causal impulse response (host f64) of lfilter(b, a).

    Every IIR in this library has poles well inside the unit circle
    (max radius 0.89 across all decimator designs), so the response decays
    below f64 eps within ~300 taps: convolution with the truncated response
    is numerically EXACT even against the float64 reference recurrence
    (same argument as _smooth_zero_phase_kernel, f0/harvest.py:675-695).
    b, a: coefficient tuples (hashable)."""
    from scipy import signal as _ss

    imp = np.zeros(4096)
    imp[0] = 1.0
    h = _ss.lfilter(np.asarray(b, np.float64), np.asarray(a, np.float64),
                    imp)
    mag = np.abs(h)
    if mag.max() == 0.0:
        return h[:1].copy()
    nz = np.nonzero(mag > mag.max() * 1e-17)[0]
    return h[: int(nz[-1]) + 1].copy()


_FIR_TILE = 128  # output samples per Toeplitz matmul column block


@functools.lru_cache(maxsize=None)
def _toeplitz_kernel(b, a):
    """(T+S-1, S) host-f64 Toeplitz matrix H with H[i, s] = h[s + T-1 - i]
    (zero outside), so y_tile = seg @ H computes S causal outputs per
    (S+T-1)-sample input tile.  Returns (h_len, H)."""
    h = _trunc_impulse(b, a)
    T = h.shape[0]
    S = _FIR_TILE
    H = np.zeros((S + T - 1, S))
    for s in range(S):
        H[s : s + T, s] = h[::-1]
    return T, H


@custom_vmap
def _fir_conv_cv(xp, H):
    """Causal FIR y[t] = sum_j h[j] xp[t + T-1 - j] for one (n+T-1,) row as
    overlap-save: strided (M, S+T-1) input tiles @ the (S+T-1, S) Toeplitz
    kernel — one matmul instead of a per-tap column reduce or a log-depth
    scan of dozens of sequential kernels.  Region-barriered + per-row unrolled
    under vmap for the same shape-determinism contract as the scans."""
    xp = lax.optimization_barrier(xp)
    S = H.shape[1]
    T = H.shape[0] - S + 1
    n = xp.shape[-1] - (T - 1)
    M = -(-n // S)
    # overlapping (M, S+T-1) tiles from k row-shifted reshape copies — pure
    # data movement, no arithmetic on the signal
    k = -(-(S + T - 1) // S)
    xpp = jnp.pad(xp, (0, (M + k) * S - n - (T - 1)))
    rows = xpp.reshape(M + k, S)
    tiles = jnp.concatenate([rows[i : M + i] for i in range(k)],
                            axis=1)[:, : S + T - 1]
    y = jnp.dot(tiles, H, preferred_element_type=xp.dtype,
                precision=jax.lax.Precision.HIGHEST)
    return lax.optimization_barrier(y.reshape(-1)[:n])


@_fir_conv_cv.def_vmap
def _fir_conv_cv_rule(axis_size, in_batched, xp, H):
    if in_batched[1]:
        # per-row Toeplitz kernels never occur here (static filter designs);
        # silently taking H[0] would apply row 0's filter to every row
        raise NotImplementedError("vmap over Toeplitz filter kernels")
    outs = [_fir_conv_cv(xp[i] if in_batched[0] else xp, H)
            for i in range(axis_size)]
    return jnp.stack(outs), True


def _fir_causal(x, b, a, pre):
    """y[t] = sum_j h[j] * x[t-j] with x[t<0] := pre — exactly
    lfilter(b, a, x) from zero state (pre=0) or from the constant-input
    steady state (pre=x0, scipy's ``zi=lfilter_zi*x0``), with h the
    truncated impulse response.  x: (..., n); pre broadcastable (..., 1)."""
    x = jnp.asarray(x)
    T, H_np = _toeplitz_kernel(tuple(np.atleast_1d(b).tolist()),
                               tuple(np.atleast_1d(a).tolist()))
    n = x.shape[-1]
    Hj = jnp.asarray(H_np, x.dtype)
    pre_b = jnp.broadcast_to(jnp.asarray(pre, x.dtype),
                             x.shape[:-1] + (T - 1,))
    xp = jnp.concatenate([pre_b, x], axis=-1)
    lead = xp.shape[:-1]
    if lead:
        y = jnp.stack([_fir_conv_cv(r, Hj)
                       for r in xp.reshape((-1, xp.shape[-1]))])
        return y.reshape(lead + (n,))
    return _fir_conv_cv(xp, Hj)


def _nofma(a, b):
    """a*b, pinned so a consuming add can NOT contract it into an FMA.

    XLA may contract ``p*q + r`` into fma(p, q, r), and whether it does is
    shape-dependent, which makes vmapped results drift ~1 ulp from
    single-stream ones.  The barrier sits
    on the product only — constant folding and the scan structure are
    untouched (barriering more than this measurably re-introduces drift)."""
    return lax.optimization_barrier(a * b)


def lfilter_coeffs_state_space(b, a):
    """Direct-form-II-transposed state space (A, B, b0) for lfilter(b, a).

    y_t = b0 x_t + s_{t-1}[0];  s_t = A s_{t-1} + B x_t.
    b, a are host-side numpy arrays (a[0] == 1), static per filter design.
    """
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    assert abs(a[0] - 1.0) < 1e-12
    k = max(len(a), len(b)) - 1
    bp = np.zeros(k + 1)
    bp[: len(b)] = b
    ap = np.zeros(k + 1)
    ap[: len(a)] = a
    A = np.zeros((k, k))
    B = np.zeros(k)
    for i in range(k):
        if i + 1 < k:
            A[i, i + 1] = 1.0
        A[i, 0] -= ap[i + 1]
        B[i] = bp[i + 1] - ap[i + 1] * bp[0]
    return A, B, bp[0]


def lfilter(b, a, x, zi=None):
    """scipy.signal.lfilter equivalent via associative scan.

    b, a: static (host) coefficient arrays.  x: (..., n).  zi: optional
    initial state (..., k) in DF2T convention (same as scipy's zi).
    """
    A, B, b0 = lfilter_coeffs_state_space(b, a)
    x = jnp.asarray(x)
    A_j = jnp.asarray(A, dtype=x.dtype)
    B_j = jnp.asarray(B, dtype=x.dtype)
    bx = x[..., None] * B_j
    s = linear_recurrence(A_j, bx, s0=zi)
    # y_t = b0 x_t + s_{t-1}[0]
    s_prev0 = jnp.concatenate(
        [jnp.zeros_like(s[..., :1, 0]) if zi is None else jnp.asarray(zi)[..., None, 0],
         s[..., :-1, 0]], axis=-1)
    return _nofma(b0, x) + s_prev0


def filtfilt(b, a, x, padlen):
    """scipy.signal.filtfilt(method='pad', padtype='odd') equivalent.

    Matches the reference decimator (/root/reference/world/harvest.py:599-603)
    which calls filtfilt with an explicit padlen.  Each pass's
    ``zi = lfilter_zi * x0`` initialization IS the constant-x0-prehistory
    filter, so both passes run as truncated-FIR Toeplitz matmuls
    (overlap-save, :func:`_fir_causal`) — exact to the f64 tail, no
    sequential scan.
    """
    x = jnp.asarray(x)
    # odd extension (products pinned: 2*x - rev must not contract into FMA)
    left = _nofma(2.0, x[..., :1]) - x[..., 1 : padlen + 1][..., ::-1]
    right = _nofma(2.0, x[..., -1:]) - x[..., -padlen - 1 : -1][..., ::-1]
    ext = jnp.concatenate([left, x, right], axis=-1)
    y = _fir_causal(ext, b, a, ext[..., :1])
    y = y[..., ::-1]
    y = _fir_causal(y, b, a, y[..., :1])
    y = y[..., ::-1]
    return y[..., padlen:-padlen]


@functools.lru_cache(maxsize=None)
def cheby1_sos(order: int, rp: float, wn: float):
    from scipy import signal as _ss

    bb, aa = _ss.cheby1(order, rp, wn)
    return tuple(bb.tolist()), tuple(aa.tolist())


def decimate_matlab(x, q: int, order: int = 3):
    """MATLAB-style decimate used by harvest/dio's downsampler.

    cheby1(order, 0.05, 0.8/q) filtfilt (padlen 3*(ntaps-1)) then MATLAB
    phase-aligned downsampling (/root/reference/world/harvest.py:584-609).
    The returned length follows the MATLAB convention.
    """
    b, a = cheby1_sos(order, 0.05, 0.8 / q)
    padlen = 3 * (max(len(a), len(b)) - 1)
    y = filtfilt(b, a, x, padlen)
    nd = y.shape[-1]
    n_out = int(np.ceil(nd / q))
    n_beg = int(q - (q * n_out - nd))
    return y[..., n_beg - 1 :: q]


# ---------------------------------------------------------------------------
# The hand-rolled zero-phase decimation filter of dio
# (/root/reference/world/dio.py:359-476): a fixed-coefficient 3rd-order
# recursive low-pass run forward+backward twice over a reflect-padded signal.
# ---------------------------------------------------------------------------

_DECIMATE_COEFFS = {
    11: ((2.450743295230728, -2.06794904601978, 0.59574774438332101),
         (0.0026822508007163792, 0.0080467524021491377)),
    12: ((2.4981398605924205, -2.1368928194784025, 0.62187513816221485),
         (0.0021097275904709001, 0.0063291827714127002)),
    10: ((2.3936475118069387, -1.9873904075111861, 0.5658879979027055),
         (0.0034818622251927556, 0.010445586675578267)),
    9: ((2.3236003491759578, -1.8921545617463598, 0.53148928133729068),
        (0.0046331164041389372, 0.013899349212416812)),
    8: ((2.2357462340187593, -1.7780899984041358, 0.49152555365968692),
        (0.0063522763407111993, 0.019056829022133598)),
    7: ((2.1225239019534703, -1.6395144861046302, 0.44469707800587366),
        (0.0090366882681608418, 0.027110064804482525)),
    6: ((1.9715352749512141, -1.4686795689225347, 0.3893908434965701),
        (0.013469181309343825, 0.040407543928031475)),
    5: ((1.7610939654280557, -1.2554914843859768, 0.3237186507788215),
        (0.021334858522387423, 0.06400457556716227)),
    4: ((1.4499664446880227, -0.98943497080950582, 0.24578252340690215),
        (0.036710750339322612, 0.11013225101796784)),
    3: ((0.95039378983237421, -0.67429146741526791, 0.15412211621346475),
        (0.071221945171178636, 0.21366583551353591)),
    2: ((0.041156734567757189, -0.42599112459189636, 0.041037215479961225),
        (0.16797464681802227, 0.50392394045406674)),
}


def _filter_for_decimate(x, r: int):
    """One forward pass of the WORLD decimation filter (dio.py:359-446).

    Recurrence: w_t = x_t + a0 w_{t-1} + a1 w_{t-2} + a2 w_{t-3};
                y_t = b0 w_t + b1 w_{t-1} + b1 w_{t-2} + b0 w_{t-3},
    i.e. transfer (b0 + b1 z^-1 + b1 z^-2 + b0 z^-3) /
    (1 - a0 z^-1 - a1 z^-2 - a2 z^-3) from ZERO state — run as a
    truncated-FIR Toeplitz matmul (overlap-save, :func:`_fir_causal`,
    pre=0).
    """
    a, b = _DECIMATE_COEFFS.get(r, ((0.0, 0.0, 0.0), (0.0, 0.0)))
    x = jnp.asarray(x)
    b0, b1 = b
    return _fir_causal(x, (b0, b1, b1, b0), (1.0, -a[0], -a[1], -a[2]),
                       jnp.zeros((), x.dtype))


def decimate_world(x, r: int):
    """The dio downsampler (dio.py:451-476): reflect-pad 9, filtfilt, stride."""
    kn = 9
    x = jnp.asarray(x)
    x_len = x.shape[-1]
    left = _nofma(2.0, x[..., :1]) - x[..., 1 : kn + 1][..., ::-1]
    right = _nofma(2.0, x[..., -1:]) - x[..., -kn - 1 : -1][..., ::-1]
    tmp = jnp.concatenate([left, x, right], axis=-1)
    tmp = _filter_for_decimate(tmp, r)[..., ::-1]
    tmp = _filter_for_decimate(tmp, r)[..., ::-1]
    nout = int(np.ceil(x_len / r + 1))
    nbeg = int(r - r * nout + x_len)
    # y[k] = tmp[nbeg + k*r + kn - 1] for nbeg + k*r < x_len + kn
    start = nbeg + kn - 1
    count = int(np.ceil((x_len + kn - nbeg) / r))
    return lax.slice_in_dim(tmp, start, start + (count - 1) * r + 1, stride=r, axis=-1)
