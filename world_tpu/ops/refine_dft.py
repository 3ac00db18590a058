"""Harvest refinement: windows -> harmonic-bin DFT -> refined f0 and score.

GetRefinedF0 (/root/reference/world/harvest.py:169-211) reads <=6 harmonic
bins of two per-(candidate, frame) FFTs whose size depends on the candidate
f0.  Because every per-candidate fft_size is a power of two dividing S (the
f0_floor size), bin ``b`` of a size-``s`` DFT equals bin ``K = b*(S/s)`` of
ONE size-S DFT.

Two implementations of the same math, chosen by :func:`refine_impl`:

  * ``refine_full_xla`` (CPU path and test oracle) materializes the windowed
    rows, multiplies them by a static (W, 2*nb) cos/sin basis and selects the
    <=6 bins each row reads;
  * ``_refine_triton`` (GPU, float32) is one Pallas/Triton program per
    (block of frame rows, candidate): both Blackman windows are built in
    registers, each row's <=6 bins are length-W dot products whose angles
    come from ``(K*n) mod S`` in int32 (no large-argument trig error), and
    only the (C, B) results reach device memory.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import prod_diff

# rows x padded window width per Triton program (register budget: the
# windowed rows and the per-harmonic cos/sin live as (rows, width) tiles)
_TILE_ELEMS = 4096
_NUM_WARPS = 4


def refine_impl(backend: str, dtype) -> str:
    """Which refinement implementation runs: the Triton kernel for float32
    on the GPU, the XLA twin everywhere else (CPU tests, float64 oracles)."""
    if backend == "gpu" and jnp.dtype(dtype) == jnp.float32:
        return "triton"
    return "xla"


def dft_basis(W: int, nb: int, dtype):
    """Static cos/sin basis (W, 2*nb) with angles (-2*pi*k/S)*n, S=2*(nb-1).

    Computed host-side in float64 and baked in as a constant, so every entry
    is correct to one target-dtype ulp.  Angles reach ~pi*W ~ 2e3 rad, where
    float32 angle rounding plus large-argument trig error would dominate the
    candidate-score noise; the reference's FFT (harvest.py:184-193) is all
    float64.
    """
    S = 2 * (nb - 1)
    theta = np.arange(W, dtype=np.float64)[:, None] * (
        (-2.0 * np.pi) * np.arange(nb, dtype=np.float64)[None, :] / S)
    basis = np.concatenate([np.cos(theta), np.sin(theta)], axis=1)
    return jnp.asarray(basis, dtype)


def _blackman(phase, wlt, mask):
    """Harvest's Blackman main window (harvest.py:175-183) at ``phase``."""
    common = jnp.pi * phase / wlt
    mw = 0.42 + 0.5 * jnp.cos(2 * common) + 0.08 * jnp.cos(4 * common)
    return jnp.where(mask, mw, jnp.zeros((), phase.dtype))


def _windows(phase, f0, actual_fs, base_abs):
    """Blackman main window + centered-difference derivative window
    (harvest.py:175-193), for one (..., W) block."""
    dtype = phase.dtype
    half = jnp.ceil(3 * actual_fs / f0 / 2)[..., None]
    wlt = (2 * half + 1) / actual_fs
    mask = base_abs <= half
    mw = _blackman(phase, wlt, mask)
    right = jnp.pad(mw[..., 1:], [(0, 0)] * (mw.ndim - 1) + [(0, 1)])
    left = jnp.pad(mw[..., :-1], [(0, 0)] * (mw.ndim - 1) + [(1, 0)])
    dw = jnp.where(mask, -(right - left) / 2, jnp.zeros((), dtype))
    return mw, dw


def _refine_math(picked, bins, fft_size, f0, hmask, n_harm, harmonics,
                 actual_fs, f0_floor, f0_ceil):
    """picked (…, 4, 6) harmonic-bin spectra -> (refined f0, score), the
    tail of GetRefinedF0 (harvest.py:194-211)."""
    dtype = picked.dtype
    re_s, im_s = picked[..., 0, :], picked[..., 1, :]
    re_d, im_d = picked[..., 2, :], picked[..., 3, :]
    # compensated in f32: near-tied candidate scores must not flip on
    # numerator cancellation noise (see ops.prod_diff)
    numerator = prod_diff(re_s, im_d, im_s, re_d)
    power = re_s ** 2 + im_s ** 2
    inst_freq = (bins / fft_size[..., None]
                 + numerator / jnp.maximum(power, jnp.finfo(dtype).tiny)
                 / 2 / jnp.pi) * actual_fs
    amp = jnp.sqrt(power) * hmask
    refined = (jnp.sum(amp * inst_freq, axis=-1)
               / jnp.maximum(jnp.sum(amp * harmonics, axis=-1),
                             jnp.finfo(dtype).tiny))
    variation = jnp.abs((inst_freq / harmonics - f0[..., None])
                        / f0[..., None])
    score = 1.0 / (0.000000000001
                   + jnp.sum(jnp.where(hmask, variation, 0.0), axis=-1)
                   / jnp.maximum(n_harm, 1.0))
    ok = ((refined >= f0_floor) & (refined <= f0_ceil) & (score >= 2.5)
          & (f0 > 1e-6))
    return jnp.where(ok, refined, 0.0), jnp.where(ok, score, 0.0)


def _harmonic_meta(f0, actual_fs, nb, dtype):
    """(fft_size, n_harm, hmask (.., 6), bins (.., 6)) per candidate-frame:
    harvest.py:174-199's data-dependent sizes as scalars."""
    half = jnp.ceil(3 * actual_fs / f0 / 2)
    fft_size = 2.0 ** jnp.ceil(jnp.log2(half * 2 + 1) + 1)
    harmonics = jnp.arange(1, 7, dtype=dtype)
    shape = (1,) * f0.ndim + (6,)
    harmonics = harmonics.reshape(shape)
    n_harm = jnp.minimum(jnp.floor(actual_fs / 2 / f0), 6.0)
    hmask = harmonics <= n_harm[..., None]
    bins = jnp.trunc(f0[..., None] * fft_size[..., None] / actual_fs
                     * harmonics + 0.5)
    return fft_size, n_harm, hmask, bins, harmonics


def refine_full_xla(seg, phase, f0, basis, actual_fs, max_half, nb,
                    f0_floor, f0_ceil):
    """Plain-XLA twin (CPU path / test oracle): same math, materialized."""
    from ..dsp.scanops import select_rows_small

    dtype = seg.dtype
    W = seg.shape[1]
    C, B = f0.shape
    S = 2 * (nb - 1)
    base_index = jnp.arange(-max_half, max_half + 1, dtype=dtype)
    mw, dw = _windows(phase[None], f0, actual_fs, jnp.abs(base_index)[None, None, :])
    X = jnp.concatenate([(seg[None] * mw).reshape(-1, W),
                         (seg[None] * dw).reshape(-1, W)])
    spec = jnp.dot(X, basis, preferred_element_type=dtype,
                   precision=jax.lax.Precision.HIGHEST)  # (2CB, 2nb)
    quads = jnp.stack([spec[: C * B, :nb], spec[: C * B, nb:],
                       spec[C * B :, :nb], spec[C * B :, nb:]], axis=1)

    fft_size, n_harm, hmask, bins, harmonics = _harmonic_meta(
        f0, actual_fs, nb, dtype)
    K = jnp.clip(bins * (S / fft_size[..., None]), 0, S // 2)
    picked = select_rows_small(quads, K.astype(jnp.int32).reshape(C * B, 1, 6))
    picked = picked.reshape(C, B, 4, 6)
    return _refine_math(picked, bins, fft_size, f0, hmask, n_harm, harmonics,
                        actual_fs, f0_floor, f0_ceil)


# ---------------------------------------------------------------------------
# Triton kernel
# ---------------------------------------------------------------------------

def _kernel(seg_ref, phl_ref, phc_ref, phr_ref, f0_ref, ref_ref, score_ref,
            **statics):
    f0 = f0_ref[0, :]                                  # (rows,)
    # candidates are rank-compacted per frame, so high slots are empty for
    # most frame blocks: those programs only write zeros
    active = jnp.max(f0) > 1e-6

    @pl.when(active)
    def _():
        refined, score = _kernel_body(seg_ref, phl_ref, phc_ref, phr_ref, f0,
                                      **statics)
        ref_ref[0, :] = refined
        score_ref[0, :] = score

    @pl.when(jnp.logical_not(active))
    def _():
        ref_ref[0, :] = jnp.zeros_like(f0)
        score_ref[0, :] = jnp.zeros_like(f0)


def _kernel_body(seg_ref, phl_ref, phc_ref, phr_ref, f0, *, actual_fs,
                 max_half, W, nb, f0_floor, f0_ceil):
    dtype = jnp.float32
    seg = seg_ref[...]                                 # (rows, Wp)
    Wp = seg.shape[1]
    S = 2 * (nb - 1)
    n = jnp.arange(Wp, dtype=jnp.int32)[None, :]
    base = n - max_half
    half_1d = jnp.ceil(3 * actual_fs / f0 / 2)
    half = half_1d[:, None]
    wlt = (2 * half + 1) / actual_fs

    def in_window(b):
        return jnp.abs(b).astype(dtype) <= half

    # the derivative window needs the main window at n-1 and n+1; both are
    # evaluated directly from the neighbouring phases (zero past the ends,
    # as the reference's zero-padded difference)
    mask = in_window(base) & (n < W)
    mw = _blackman(phc_ref[...], wlt, mask)
    mw_l = _blackman(phl_ref[...], wlt, in_window(base - 1) & (n >= 1))
    mw_r = _blackman(phr_ref[...], wlt, in_window(base + 1) & (n < W - 1))
    dw = jnp.where(mask, -(mw_r - mw_l) / 2, 0.0)
    xm = seg * mw
    xd = seg * dw

    # fft_size = 2^(ceil(log2(2*half+1)) + 1), by doubling (exact; invalid
    # candidates with a huge half saturate at 2^31 and are masked below).
    # Both loops stay loops in the kernel (scf.for), which keeps the Triton
    # compile short
    v = 2 * half_1d + 1
    pow2 = jax.lax.fori_loop(0, 31, lambda _, p: jnp.where(p < v, p * 2, p),
                             jnp.ones_like(f0))
    fft_size = 2 * pow2
    n_harm = jnp.minimum(jnp.floor(actual_fs / 2 / f0), 6.0)
    tiny = jnp.finfo(dtype).tiny
    step = np.float32(2 * np.pi / S)

    def harmonic(i, acc):
        num_acc, den_acc, var_acc = acc
        h = (i + 1).astype(dtype)
        bins = jnp.trunc(f0 * fft_size / actual_fs * h + 0.5)
        K = jnp.clip(bins * (S / fft_size), 0, S // 2).astype(jnp.int32)
        r = (K[:, None] * n) & (S - 1)                 # (K*n) mod S
        r = jnp.where(r >= S // 2, r - S, r)           # angle in [-pi, pi)
        theta = r.astype(dtype) * step
        c = jnp.cos(theta)
        s = jnp.sin(theta)                             # basis sin is -s
        re_s = jnp.sum(xm * c, axis=1)
        im_s = -jnp.sum(xm * s, axis=1)
        re_d = jnp.sum(xd * c, axis=1)
        im_d = -jnp.sum(xd * s, axis=1)
        numerator = prod_diff(re_s, im_d, im_s, re_d)
        power = re_s * re_s + im_s * im_s
        inst = (bins / fft_size
                + numerator / jnp.maximum(power, tiny) / 2 / jnp.pi
                ) * actual_fs
        hm = h <= n_harm
        amp = jnp.where(hm, jnp.sqrt(power), 0.0)
        return (num_acc + amp * inst, den_acc + amp * h,
                var_acc + jnp.where(hm, jnp.abs((inst / h - f0) / f0), 0.0))

    zero = jnp.zeros_like(f0)
    num_acc, den_acc, var_acc = jax.lax.fori_loop(0, 6, harmonic,
                                                  (zero, zero, zero))
    refined = num_acc / jnp.maximum(den_acc, tiny)
    score = 1.0 / (0.000000000001 + var_acc / jnp.maximum(n_harm, 1.0))
    ok = ((refined >= f0_floor) & (refined <= f0_ceil) & (score >= 2.5)
          & (f0 > 1e-6))
    return jnp.where(ok, refined, 0.0), jnp.where(ok, score, 0.0)


def _tile_rows(W: int):
    """(rows per program, padded width): powers of two, rows*width fixed."""
    Wp = int(pl.next_power_of_2(W))
    return max(1, min(64, _TILE_ELEMS // Wp)), Wp


@partial(jax.jit, static_argnames=("actual_fs", "max_half", "nb", "f0_floor",
                                   "f0_ceil", "interpret"))
def _refine_triton(seg, phase, f0, actual_fs, max_half, nb, f0_floor,
                   f0_ceil, interpret=False):
    if seg.dtype != jnp.float32:
        raise TypeError(f"refinement kernel is float32-only, got {seg.dtype}")
    C, B = f0.shape
    W = seg.shape[1]
    rows, Wp = _tile_rows(W)
    Bp = -(-B // rows) * rows
    seg = jnp.pad(seg, ((0, Bp - B), (0, Wp - W)))
    # phase at n-1, n, n+1 (column k+1 of the padded array holds phase[k])
    ph = jnp.pad(phase, ((0, Bp - B), (1, Wp - W + 1)))
    ph_l, ph_c, ph_r = ph[:, :Wp], ph[:, 1 : Wp + 1], ph[:, 2:]
    f0 = jnp.pad(f0, ((0, 0), (0, Bp - B)))            # 0: empty candidate
    kernel = partial(_kernel, actual_fs=actual_fs, max_half=max_half, W=W,
                     nb=nb, f0_floor=f0_floor, f0_ceil=f0_ceil)
    row_spec = pl.BlockSpec((rows, Wp), lambda i, j: (i, 0))
    out_spec = pl.BlockSpec((1, rows), lambda i, j: (j, i))
    refined, score = pl.pallas_call(
        kernel,
        grid=(Bp // rows, C),
        in_specs=[row_spec, row_spec, row_spec, row_spec, out_spec],
        out_specs=[out_spec, out_spec],
        out_shape=[jax.ShapeDtypeStruct((C, Bp), jnp.float32)] * 2,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="harvest_refine",
    )(seg, ph_l, ph_c, ph_r, f0)
    return refined[:, :B], score[:, :B]


def _refine_triton_batchable(actual_fs, max_half, nb, f0_floor, f0_ceil,
                             interpret=False):
    """custom_vmap wrapper over the kernel: an utterance-batch axis is folded
    into the frame-row axis B (utterance-major) and the SAME kernel runs once
    over N*B rows.  Rows are independent, so every batched row is bitwise
    identical to its single-stream result (Pallas' own batching would add a
    grid axis instead)."""
    from jax.custom_batching import custom_vmap

    statics = (actual_fs, max_half, nb, f0_floor, f0_ceil)

    @custom_vmap
    def fn(seg, phase, f0):
        return _refine_triton(seg, phase, f0, *statics, interpret=interpret)

    @fn.def_vmap
    def _rule(axis_size, in_batched, seg, phase, f0):
        def bcast(a, batched):
            return a if batched else jnp.broadcast_to(
                a[None], (axis_size,) + a.shape)

        seg, phase, f0 = (bcast(a, b) for a, b in
                          zip((seg, phase, f0), in_batched))
        N, B, W = seg.shape
        C = f0.shape[1]
        r, s = fn(seg.reshape(N * B, W), phase.reshape(N * B, W),
                  jnp.moveaxis(f0, 0, 1).reshape(C, N * B))
        r = jnp.moveaxis(r.reshape(C, N, B), 1, 0)
        s = jnp.moveaxis(s.reshape(C, N, B), 1, 0)
        return (r, s), (True, True)

    return fn


def get_refined_f0_np(x, fs, current_time, current_f0, f0_floor, f0_ceil,
                      gate=True):
    """Float64 NumPy GetRefinedF0 (harvest.py:169-211) for ONE (candidate,
    frame): the plain reference both implementations are held to.  ``x`` is
    the downsampled signal, ``fs`` its rate.  ``gate=False`` returns the
    (refined, score) pair before the accept/reject test."""
    x = np.asarray(x, np.float64)
    half = np.ceil(3 * fs / current_f0 / 2)
    wlt = (2 * half + 1) / fs
    fft_size = int(2 ** np.ceil(np.log2(half * 2 + 1) + 1))
    base = np.arange(-half, half + 1)
    raw = (current_time + base / fs) * fs + 0.001
    # the reference's round_matlab shifts by +-0.5 without truncating; the
    # window is built from that value, the gather truncates it
    base_index = np.where(raw > 0, raw + 0.5, raw - 0.5)
    window_time = (base_index - 1) / fs - current_time
    arg = np.pi * window_time / wlt
    mw = 0.42 + 0.5 * np.cos(2 * arg) + 0.08 * np.cos(4 * arg)
    dw = -(np.diff(np.r_[0.0, mw]) + np.diff(np.r_[mw, 0.0])) / 2
    seg = x[np.clip(base_index, 1, len(x)).astype(int) - 1]
    main = np.fft.fft(seg * mw, fft_size)
    diff = np.fft.fft(seg * dw, fft_size)
    numerator = main.real * diff.imag - main.imag * diff.real
    power = np.abs(main) ** 2
    inst = (np.arange(fft_size) / fft_size
            + numerator / power / 2 / np.pi) * fs
    harmonics = np.arange(1, int(min(np.floor(fs / 2 / current_f0), 6)) + 1)
    idx = np.floor(current_f0 * fft_size / fs * harmonics + 0.5).astype(int)
    amp = np.sqrt(power[idx])
    refined = np.sum(amp * inst[idx]) / np.sum(amp * harmonics)
    variation = np.abs((inst[idx] / harmonics - current_f0) / current_f0)
    score = 1 / (0.000000000001 + np.mean(variation))
    if not gate:
        return float(refined), float(score)
    if refined < f0_floor or refined > f0_ceil or score < 2.5:
        return 0.0, 0.0
    return float(refined), float(score)


def refine_full(seg, phase, f0, actual_fs, max_half, nb, f0_floor, f0_ceil):
    """(refined_f0, score) (C, B) for every (candidate, frame) — the full
    GetRefinedF0 grid (harvest.py:131-150) as one fused pass."""
    args = (float(actual_fs), int(max_half), int(nb), float(f0_floor),
            float(f0_ceil))
    if refine_impl(jax.default_backend(), seg.dtype) == "triton":
        return _refine_triton_batchable(*args)(seg, phase, f0)
    basis = dft_basis(seg.shape[1], nb, seg.dtype)
    return refine_full_xla(seg, phase, f0, basis, *args)
