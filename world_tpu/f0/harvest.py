"""Harvest F0 estimator — the framework centerpiece, as fixed-shape batches.

Mirrors /root/reference/world/harvest.py semantically; the execution design
replaces every per-item CPU loop with a batched device program:

  * ~145 band-pass filters -> ONE im2col matmul (dsp.fir) + static slices;
  * ragged zero-crossing event lists never materialize: candidate f0s come
    from the gather-free dense interval interpolation in f0.events;
  * DetectCandidates' per-frame run detection -> batched binary search over
    per-frame cumsums (no Python loops, no scatters);
  * the mp.Pool fan-out over (candidate, frame) refinement tasks
    (harvest.py:140-142, the reference's dominant cost) -> a fully batched
    harmonic-bin DFT: per-frame segments are shared across candidates and
    each task reads its <=6 harmonic bins as fused multiply-reduce dots,
    making the per-task data-dependent fft_size a scalar in the phase
    formula — static shapes, no FFT, no process pool;
  * RemoveUnreliableCandidates' O(cand x frame) numba loop -> a single
    batched min-reduction over neighbor-frame candidate error matrices;
  * FixStep3's sequential ExtendF0 chains -> per-section lax.scan, vmapped
    across sections; MergeF0 -> a lax.scan over section slots;
  * SmoothF0's per-section zero-phase biquad -> ONE batched FFT convolution
    with the filter's static symmetric zero-phase kernel (exact: the poles
    die out within the reference's own 300-sample pad).
"""
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..dsp.iir import decimate_matlab
from ..dsp.rounding import matlab_round_half
from ..dsp.windows import np_nuttall

EPS = 2.220446049250313e-16


# ---------------------------------------------------------------------------
# downsampling + band candidate generation
# ---------------------------------------------------------------------------

def _round_half_up(v: float) -> int:
    return int(math.floor(v + 0.5))


def downsample(x, fs: int, target_fs: int = 8000):
    """CalculateDownsampledSignal (harvest.py:58-71)."""
    ratio = int(fs / target_fs + 0.5)
    if fs <= target_fs:
        y = x
        actual_fs = float(fs)
    else:
        offset = int(np.ceil(140 / ratio) * ratio)
        xp = jnp.concatenate([jnp.full(offset, x[0], x.dtype), x,
                              jnp.full(offset, x[-1], x.dtype)])
        y0 = decimate_matlab(xp, ratio, order=3)
        actual_fs = fs / ratio
        y = y0[offset // ratio : -(offset // ratio)]
    return y - jnp.mean(y), actual_fs


def _band_filter_bank(boundary_f0_list: np.ndarray, actual_fs: float):
    """Static per-band Nuttall band-pass FIRs (harvest.py:252-257)."""
    halfs = [_round_half_up(actual_fs / bf * 2) for bf in boundary_f0_list]
    max_len = 2 * max(halfs) + 1
    bank = np.zeros((len(halfs), max_len))
    bias = np.zeros(len(halfs), dtype=np.int64)
    for i, (h, bf) in enumerate(zip(halfs, boundary_f0_list)):
        n = 2 * h + 1
        w = np_nuttall(n)
        shifter = np.cos(2 * np.pi * bf * np.arange(-h, h + 1) / actual_fs)
        bank[i, :n] = w * shifter
        bias[i] = h + 1
    return bank, bias


def raw_band_candidates(y, actual_fs, boundary_f0_list, temporal_positions,
                        f0_floor, f0_ceil, fft_size: int, capacity: int,
                        band_chunk: int = None):
    """CalculateCandidates (harvest.py:75-84): (n_bands, n_frames) f0 means.

    Band filtering runs as ONE im2col matmul (dsp.fir) — the reference's
    zero-padded FFT products (harvest.py:259-261) compute the identical
    linear convolution.  Events/interp run batched over all bands
    (f0.events).

    ``band_chunk``: if set, process the band axis in lax.map chunks of that
    many bands.  Bands are independent, so this bounds live device memory
    at O(band_chunk * y_len) instead of O(n_bands * y_len) — needed for
    minutes-long audio (at 60 s the all-bands event tensors alone are
    ~28 GB of temporaries).
    """
    from .events import four_event_interp
    from ..dsp.fir import fir_bank_full

    del fft_size, capacity  # retained for API compat; unused in conv path
    bank, bias = _band_filter_bank(np.asarray(boundary_f0_list), actual_fs)
    bf_np = np.asarray(boundary_f0_list, dtype=np.float64)
    n_bands = bank.shape[0]
    y_len = y.shape[0]
    # minutes-long audio: block the convolution (overlap-add scan) so the
    # im2col column matrix stays O(block*L) instead of O(y_len*L)
    block = 16384 if y_len > 65536 else None
    stride = actual_fs * 0.001  # 1 ms basic frame grid

    def postprocess(f0c, bf_rows):
        bad = ((f0c > bf_rows[:, None] * 1.1) | (f0c < bf_rows[:, None] * 0.9)
               | (f0c > f0_ceil) | (f0c < f0_floor))
        return jnp.where(bad, 0.0, f0c)

    if band_chunk is None or n_bands <= band_chunk:
        conv = fir_bank_full(y, bank, block=block)      # (B, y_len + L - 1)
        # per-band offsets are host-known -> static slices, no gather
        filtered = jnp.stack([conv[b, int(s) : int(s) + y_len]
                              for b, s in enumerate(bias)])
        f0c, _, _ = four_event_interp(filtered, actual_fs,
                                      temporal_positions, stride)
        return postprocess(f0c, jnp.asarray(bf_np, dtype=y.dtype))

    pad = (-n_bands) % band_chunk
    n_chunks = (n_bands + pad) // band_chunk
    bank_p = np.pad(bank, ((0, pad), (0, 0)))
    bias_p = np.pad(bias, (0, pad))
    # padded rows: zero filter -> zero signal -> <3 events -> f0c = 0, and
    # bf=1 forces the range check to zero them regardless; rows are dropped
    bf_p = np.pad(bf_np, (0, pad), constant_values=1.0)

    def one_chunk(args):
        bank_c, bias_c, bf_c = args
        conv = fir_bank_full(y, bank_c, block=block)
        filtered = jax.vmap(
            lambda row, s: jax.lax.dynamic_slice(row, (s,), (y_len,)))(
                conv, bias_c)
        f0c, _, _ = four_event_interp(filtered, actual_fs,
                                      temporal_positions, stride)
        return postprocess(f0c, bf_c)

    chunks = jax.lax.map(one_chunk, (
        jnp.asarray(bank_p.reshape(n_chunks, band_chunk, -1), dtype=y.dtype),
        jnp.asarray(bias_p.reshape(n_chunks, band_chunk), dtype=jnp.int32),
        jnp.asarray(bf_p.reshape(n_chunks, band_chunk), dtype=y.dtype)))
    return chunks.reshape(n_chunks * band_chunk, -1)[:n_bands]


# ---------------------------------------------------------------------------
# candidate detection / overlap (harvest.py:88-125)
# ---------------------------------------------------------------------------

def detect_candidates(raw, max_candidates: int, threshold: int = 10):
    """Per-frame runs of >=threshold positive bands -> mean f0.

    Fully scatter-free: run boundaries come from batched binary searches over
    per-frame cumsums; run sums are cumsum differences.
    """
    n_bands, n_frames = raw.shape
    max_runs = n_bands // 2 + 1
    pos = raw > 0
    band_idx = jnp.arange(n_bands)
    # reference zeroes the first and last band before run detection
    pos = pos & (band_idx[:, None] > 0) & (band_idx[:, None] < n_bands - 1)
    prev = jnp.concatenate([jnp.zeros((1, n_frames), bool), pos[:-1]])
    nxt = jnp.concatenate([pos[1:], jnp.zeros((1, n_frames), bool)])
    start = (pos & ~prev).astype(jnp.int32)
    end = (pos & ~nxt).astype(jnp.int32)

    from ..dsp.scanops import count_less_rows, select_rows_small

    cs_start = jnp.cumsum(start, axis=0).T       # (frames, bands)
    cs_end = jnp.cumsum(end, axis=0).T
    q = jnp.arange(1, max_runs + 1, dtype=jnp.int32)
    # rows are short (n_bands): compare-reduce beats binary-search gathers
    start_pos = count_less_rows(cs_start, q, side="left")
    end_pos = count_less_rows(cs_end, q, side="left")
    n_runs = cs_start[:, -1]                      # (frames,)
    run_valid = jnp.arange(max_runs)[None, :] < n_runs[:, None]
    start_pos = jnp.minimum(start_pos, n_bands - 1)
    end_pos = jnp.minimum(end_pos, n_bands - 1)

    raw_cs = jnp.cumsum(raw, axis=0).T            # (frames, bands)
    zero = jnp.zeros((n_frames, 1), raw.dtype)
    raw_cs0 = jnp.concatenate([zero, raw_cs], axis=1)
    sums = (select_rows_small(raw_cs0, end_pos + 1)
            - select_rows_small(raw_cs0, start_pos))
    lens = end_pos - start_pos + 1
    qualify = run_valid & (lens >= threshold)
    means = jnp.where(qualify, sums / jnp.maximum(lens, 1), 0.0)

    # compact qualifying runs (in run order) to the first max_candidates rows
    cq = jnp.cumsum(qualify.astype(jnp.int32), axis=1)
    qk = jnp.arange(1, max_candidates + 1, dtype=jnp.int32)
    slot_pos = count_less_rows(cq, qk, side="left")
    slot_valid = qk[None, :] <= cq[:, -1:]
    cands = jnp.where(slot_valid,
                      select_rows_small(means,
                                        jnp.minimum(slot_pos, max_runs - 1)),
                      0.0)
    n_detected = jnp.max(cq[:, -1])
    return cands.T, n_detected


def overlap_candidates(cands, max_candidates: int, n: int = 3):
    """OverlapF0Candidates (harvest.py:114-125), static-shape version.

    Stacks +/-n frame-shifted copies; replicates the reference's row-0
    initialization quirk (new[0] = cands[2n], partially overwritten)."""
    n_over = n * 2 + 1
    mc = max_candidates
    n_frames = cands.shape[1]
    rows = []
    for i in range(n_over):
        st1 = max(-(i - n) + 1, 1)
        ed1 = min(-(i - n), 0)
        width = n_frames + ed1 - (st1 - 1)
        block = jnp.zeros((mc, n_frames), cands.dtype)
        block = jax.lax.dynamic_update_slice(
            block, cands[:, -ed1 : -ed1 + width], (0, st1 - 1))
        rows.append(block)
    out = jnp.concatenate(rows, axis=0)
    # row-0 quirk: initialized from cands[n_over-1] before block 0 overwrote
    # cols [n:], leaving cols [0:n] holding cands[n_over-1, 0:n]
    leftover = jnp.where(jnp.arange(n_frames) < n, cands[n_over - 1], out[0])
    return out.at[0].set(leftover)


# ---------------------------------------------------------------------------
# refinement (harvest.py:169-211) — harmonic-bin DFT, no FFT, no pool
# ---------------------------------------------------------------------------

def _refine_block(seg, t_c, cands, actual_fs, f0_floor, f0_ceil, max_half: int):
    """GetRefinedF0 (harvest.py:169-211) for a (C, B) candidate block sharing
    per-frame segments seg (B, W) — fully batched, no vmap, no gathers.

    The per-task data-dependent fft_size is a scalar in the DFT phase
    formula; only the <=6 harmonic bins are ever computed (as fused
    multiply-reduce dots on the VPU)."""
    dtype = seg.dtype
    f0 = jnp.maximum(cands, 1e-12)                       # (C, B)

    # Window phase (reference harvest.py:178-181): round_matlab adds +/-0.5
    # WITHOUT flooring, and `common` is built from that UN-truncated value
    # (truncation to an integer index happens only at the gather, :189), so
    #   phase = ((t + base/fs)*fs + 0.001 +/- 0.5 - 1)/fs - t
    #         = (base - 0.499)/fs,
    # minus an extra 1/fs on elements where the raw index
    # t*fs + base + 0.001 <= 0 (round_matlab's x<=0 branch; only the first
    # few frames, whose gathers clamp to sample 1).  The constant part is
    # computed host-side in f64 — no t*fs at ~5e4 magnitude on device, so
    # the phase is frame-independent and bitwise deterministic across
    # backends/batch shapes.  The branch mask's t*fs only matters at small t
    # (|base| <= max_half), where f32 error << the 0.001 boundary margin.
    base = np.arange(-max_half, max_half + 1, dtype=np.float64)
    phase_c = jnp.asarray((base - 0.499) / np.float64(actual_fs), dtype)
    inv_fs = jnp.asarray(np.float64(1.0) / actual_fs, dtype)
    raw = (t_c[:, None] * jnp.asarray(actual_fs, dtype)
           + jnp.asarray(base, dtype)[None, :] + 0.001)
    phase = phase_c[None, :] - (raw <= 0.0).astype(dtype) * inv_fs  # (B, W)

    # Every per-candidate fft_size is a power of two <= S (the f0_floor
    # size), so bin `bins` of a size-fft_size DFT is bin K = bins*(S/fft_size)
    # of ONE size-S DFT: the <=6 per-(cand,frame) harmonic bins of the
    # data-dependent-size DFTs are read from one size-S DFT whose angles
    # (-2pi*K/S)*n equal the reference arithmetic (-2pi*bins/fft_size)*n
    # because K/S == bins/fft_size exactly.  ops.refine_dft runs it as a
    # Triton kernel on the GPU and as a basis matmul elsewhere.
    S = int(2 ** np.ceil(np.log2(2 * max_half + 1) + 1))
    nb = S // 2 + 1

    from ..ops.refine_dft import refine_full

    return refine_full(seg, phase, f0, actual_fs, max_half, nb,
                       f0_floor, f0_ceil)


def _bucket_caps(max_half: int):
    """Descending half-width caps whose DFT sizes shrink by 2 per step.

    Every candidate fft_size is 2^ceil(log2(2*half+1)+1), so a candidate with
    half <= cap fits a basis of size S(cap); the next cap is the largest half
    whose fft still fits S(cap)/2."""
    caps = [max_half]
    while True:
        S = int(2 ** np.ceil(np.log2(2 * caps[-1] + 1) + 1))
        nxt = (S // 4 - 1) // 2
        if nxt < 16 or nxt >= caps[-1]:
            return caps
        caps.append(nxt)


def _refine_bucketed(seg, t_c, cands, actual_fs, f0_floor, f0_ceil,
                     max_half: int):
    """GetRefinedF0 fan-out split into f0 buckets of shrinking window/DFT
    size.  High candidates only need short windows (half = ceil(3*fs/f0/2))
    and small ffts; running them through the full-size basis wastes
    W*S ~ 16x the flops for a 4x-smaller window.  Per bucket the candidates
    re-compact into their own slot grid (rank-select, exact copies), the
    shared frame segments take a static central slice, and the SAME kernel
    runs at the bucket's native (W, S).  Results match the single-bucket
    path to the last ulp (basis angles depend only on K/S == bins/fft and
    dropped columns multiply masked-zero window samples; only the summation
    order of the nonzero terms may differ)."""
    from ..dsp.scanops import count_less_rows, select_rows_small

    caps = _bucket_caps(max_half)
    if len(caps) == 1:
        return _refine_block(seg, t_c, cands, actual_fs, f0_floor, f0_ceil,
                             max_half)
    C2, F = cands.shape
    # min f0 admitted to cap: ceil(3*fs/f0/2) <= cap, with a half-sample
    # guard against f32 rounding at the boundary
    thr = [3.0 * actual_fs / (2.0 * (c - 0.5)) for c in caps]
    nz = cands > 0
    ref_out = jnp.zeros_like(cands)
    score_out = jnp.zeros_like(cands)
    qk = jnp.arange(1, C2 + 1, dtype=jnp.int32)
    for b, cap in enumerate(caps):
        if b == 0:
            memb = nz & (cands < thr[1])
        elif b == len(caps) - 1:
            memb = nz & (cands >= thr[b])
        else:
            memb = nz & (cands >= thr[b]) & (cands < thr[b + 1])
        membT = memb.T
        rank = jnp.cumsum(membT.astype(jnp.int32), axis=1)     # (F, C2)
        pos = count_less_rows(rank, qk)
        slot_valid = qk[None, :] <= rank[:, -1:]
        comp = jnp.where(slot_valid,
                         select_rows_small(cands.T, jnp.minimum(pos, C2 - 1)),
                         0.0).T
        seg_b = seg[:, max_half - cap : max_half + cap + 1]
        r_b, s_b = _refine_block(seg_b, t_c, comp, actual_fs, f0_floor,
                                 f0_ceil, cap)
        idx = jnp.clip(rank - 1, 0, C2 - 1)
        ref_out = ref_out + jnp.where(
            membT, select_rows_small(r_b.T, idx), 0.0).T
        score_out = score_out + jnp.where(
            membT, select_rows_small(s_b.T, idx), 0.0).T
    return ref_out, score_out


def refine_candidates(y, actual_fs, temporal_positions, cands, f0_floor, f0_ceil,
                      max_half: int, stride_samples: float = None,
                      frame_chunk: int = 4096):
    """RefineCandidates (harvest.py:131-150): per-frame segments are shared
    across all candidates (the gather index does not depend on f0), extracted
    gather-free on the uniform frame grid."""
    from ..frames import uniform_centered_slabs

    C, F = cands.shape
    W = 2 * max_half + 1
    if stride_samples is not None:
        slab = uniform_centered_slabs(y, actual_fs, stride_samples / actual_fs,
                                      F, temporal_positions, max_half + 1)
        seg = slab[:, :W]                                   # (F, W)
    else:
        center = jnp.floor(temporal_positions[:, None] * actual_fs + 0.501)
        base = jnp.arange(-max_half, max_half + 1)[None, :]
        safe = jnp.clip(center + base, 1, y.shape[0]).astype(jnp.int32)
        seg = jnp.take(y, safe - 1)

    if F <= 2 * frame_chunk or frame_chunk <= 0:
        # single block: avoids the lax.map loop entirely (the loop's carried
        # output updates cost more than the block compute at this size)
        return _refine_bucketed(seg, temporal_positions, cands, actual_fs,
                                f0_floor, f0_ceil, max_half)

    pad = (-F) % frame_chunk
    tp_p = jnp.pad(temporal_positions, (0, pad))
    seg_p = jnp.pad(seg, ((0, pad), (0, 0)))
    cands_p = jnp.pad(cands, ((0, 0), (0, pad)))
    nb = (F + pad) // frame_chunk
    tp_b = tp_p.reshape(nb, frame_chunk)
    seg_b = seg_p.reshape(nb, frame_chunk, W)
    cd_b = cands_p.reshape(C, nb, frame_chunk).transpose(1, 0, 2)

    def chunk_fn(args):
        t_c, sg_c, cd_c = args
        return _refine_bucketed(sg_c, t_c, cd_c, actual_fs, f0_floor, f0_ceil,
                                max_half)

    ref, score = jax.lax.map(chunk_fn, (tp_b, seg_b, cd_b))
    ref = ref.transpose(1, 0, 2).reshape(C, F + pad)[:, :F]
    score = score.transpose(1, 0, 2).reshape(C, F + pad)[:, :F]
    return ref, score


def remove_unreliable(cands, scores, threshold: float = 0.05):
    """RemoveUnreliableCandidates (harvest.py:215-234), one batched reduction."""
    C, F = cands.shape
    ref = jnp.maximum(cands, jnp.finfo(cands.dtype).tiny)

    def min_err_vs(other):  # other: (C, F) aligned with ref's frame axis
        # err[j, k, i] = |ref[j,i] - other[k,i]| / ref[j,i]
        e = jnp.abs(ref[:, None, :] - other[None, :, :]) / ref[:, None, :]
        return jnp.minimum(jnp.min(e, axis=1), 1.0)

    nxt = jnp.concatenate([cands[:, 1:], jnp.zeros((C, 1), cands.dtype)], axis=1)
    prv = jnp.concatenate([jnp.zeros((C, 1), cands.dtype), cands[:, :-1]], axis=1)
    min_error = jnp.minimum(min_err_vs(nxt), min_err_vs(prv))
    frame_idx = jnp.arange(F)
    interior = (frame_idx >= 1) & (frame_idx <= F - 2)
    remove = (cands != 0) & (min_error > threshold) & interior[None, :]
    return (jnp.where(remove, 0.0, cands), jnp.where(remove, 0.0, scores))


# ---------------------------------------------------------------------------
# contour fixing (harvest.py:301-495)
# ---------------------------------------------------------------------------

def _select_best_f0(reference_f0, candidates, allowed_range):
    """SelectBestF0 (harvest.py:238-248): min relative error, ties -> LAST
    minimum (the numba loop uses `tmp > best_error: continue`, so equal
    errors update).  Returns (best_f0, best_error<=allowed_range kept)."""
    err = jnp.abs(reference_f0 - candidates) / reference_f0
    # last argmin: flip, argmin of reversed picks last occurrence
    n = candidates.shape[0]
    rev = err[::-1]
    j = n - 1 - jnp.argmin(rev)
    best_err = err[j]
    ok = best_err <= allowed_range
    return jnp.where(ok, candidates[j], 0.0), jnp.minimum(best_err, allowed_range)


def search_f0_base(cands, scores):
    """Highest-score candidate per frame (harvest.py:314-319), as a one-hot
    masked sum instead of take_along_axis."""
    idx = jnp.argmax(scores, axis=0)
    rows = jnp.arange(cands.shape[0])[:, None]
    return jnp.sum(jnp.where(rows == idx[None, :], cands, 0.0), axis=0)


def fix_step1(f0_base, allowed_range: float = 0.008):
    """Zero rapid changes (harvest.py:324-338) — reads only the original
    contour, hence fully data-parallel."""
    n = f0_base.shape[0]
    p1 = jnp.concatenate([jnp.zeros(1, f0_base.dtype), f0_base[:-1]])
    p2 = jnp.concatenate([jnp.zeros(2, f0_base.dtype), f0_base[:-2]])
    ref = p1 * 2 - p2
    rapid = ((jnp.abs((f0_base - ref) / (ref + EPS)) > allowed_range)
             & (jnp.abs((f0_base - p1) / (p1 + EPS)) > allowed_range))
    i = jnp.arange(n)
    out = jnp.where((i >= 2) & (f0_base != 0) & rapid, 0.0, f0_base)
    return out.at[0].set(0.0).at[1].set(0.0)


def _sections(f0, max_sections: int):
    """Voiced sections under GetBoundaryList's edge-forcing (harvest.py:572-580).

    Returns (starts, ends, count): padded (max_sections,) int arrays."""
    n = f0.shape[0]
    v = f0 != 0
    i = jnp.arange(n)
    v = v & (i > 0) & (i < n - 1)  # vuv[0]=vuv[-1]=0 forced
    v_prev = jnp.concatenate([jnp.asarray([False]), v[:-1]])
    v_next = jnp.concatenate([v[1:], jnp.asarray([False])])
    is_start = v & ~v_prev
    is_end = v & ~v_next
    # scatter-free compaction via binary search over cumsums
    from ..dsp.scanops import searchsorted_rows

    cs = jnp.cumsum(is_start.astype(jnp.int32))
    ce = jnp.cumsum(is_end.astype(jnp.int32))
    q = jnp.arange(1, max_sections + 1, dtype=jnp.int32)
    starts = jnp.minimum(searchsorted_rows(cs[None, :], q[None, :])[0],
                         n - 1).astype(jnp.int32)
    ends = jnp.minimum(searchsorted_rows(ce[None, :], q[None, :])[0],
                       n - 1).astype(jnp.int32)
    count = jnp.minimum(cs[-1], max_sections)
    valid = jnp.arange(max_sections) < count
    starts = jnp.where(valid, starts, 0)
    ends = jnp.where(valid, ends, 0)
    return starts, ends, count


def fix_step2(f0_step1, voice_range_minimum: int = 6):
    """Remove short voiced sections (harvest.py:343-352), capacity-free:
    each voiced frame learns its run bounds via prefix/suffix scans."""
    n = f0_step1.shape[0]
    i = jnp.arange(n)
    v = (f0_step1 != 0) & (i > 0) & (i < n - 1)  # GetBoundaryList edge forcing
    v_prev = jnp.concatenate([jnp.asarray([False]), v[:-1]])
    v_next = jnp.concatenate([v[1:], jnp.asarray([False])])
    is_start = v & ~v_prev
    is_end = v & ~v_next
    run_start = jax.lax.cummax(jnp.where(is_start, i, -1))
    run_end = jax.lax.cummin(jnp.where(is_end, i, n + 10)[::-1])[::-1]
    short = v & ((run_end - run_start) < voice_range_minimum)
    return jnp.where(short, 0.0, f0_step1)


def _extend_chain(section_f0, origin, last_point, shift, cands, allowed_range,
                  n_steps: int):
    """ExtendF0 (harvest.py:408-429) as a scan of SelectBestF0 picks.

    Returns (positions (n_steps,), values (n_steps,), write_mask, shifted_origin).
    """
    def body(carry, k):
        tmp_f0, misses, shifted_origin, stopped = carry
        pos = (origin + shift * (k + 1)).astype(jnp.int32)
        in_range = jnp.where(shift > 0, pos <= last_point + 1, pos >= last_point - 1)
        # reference adjusts last_point by +shift then iterates to it inclusive
        active = (~stopped) & in_range
        val, _ = _select_best_f0(jnp.maximum(tmp_f0, jnp.finfo(tmp_f0.dtype).tiny), cands[:, pos],
                                 allowed_range)
        val = jnp.where(active, val, 0.0)
        hit = active & (val != 0)
        tmp_f0 = jnp.where(hit, val, tmp_f0)
        shifted_origin = jnp.where(hit, pos, shifted_origin)
        misses = jnp.where(hit, 0, misses + jnp.where(active, 1, 0))
        stopped = stopped | (misses >= 4) | ~in_range
        return (tmp_f0, misses, shifted_origin, stopped), (pos, val, active)

    init = (section_f0[origin], jnp.asarray(0, jnp.int32),
            jnp.asarray(origin, jnp.int32), jnp.asarray(False))
    (_, _, shifted_origin, _), (pos, vals, mask) = jax.lax.scan(
        body, init, jnp.arange(n_steps, dtype=jnp.int32))
    return pos, vals, mask, shifted_origin


def fix_step3(f0_step2, cands, scores, allowed_range: float = 0.18,
              max_sections: int = 256):
    """Extend + merge voiced sections (harvest.py:357-383)."""
    n = f0_step2.shape[0]
    starts, ends, count = _sections(f0_step2, max_sections)
    sec_valid = jnp.arange(max_sections) < count
    threshold1, threshold2 = 100, 2200.0

    def extend_one(st, ed, valid):
        # forward from section end
        lp_f = jnp.minimum(n - 2, ed + threshold1)
        pos_f, val_f, m_f, r1 = _extend_chain(
            f0_step2, ed, lp_f, 1, cands, allowed_range, threshold1 + 1)
        # backward from section start (on the already-extended contour — but
        # backward writes land strictly before the section, so the chains are
        # independent; the seed value is f0[start])
        lp_b = jnp.maximum(1, st - threshold1)
        pos_b, val_b, m_b, r0 = _extend_chain(
            f0_step2, st, lp_b, -1, cands, allowed_range, threshold1 + 1)
        # assemble the extended section row: base section + the two chains.
        # placing a 101-vector at a traced offset is done as an iota-masked
        # contraction instead of a gather or scatter
        i = jnp.arange(n)
        row = jnp.where((i >= st) & (i <= ed), f0_step2, 0.0)
        k = jnp.arange(threshold1 + 1)
        eq_f = (i[None, :] - ed - 1) == k[:, None]          # (K, n)
        vf = jnp.einsum("k,kn->n", jnp.where(m_f, val_f, 0.0), eq_f,
                        preferred_element_type=row.dtype,
                        precision=jax.lax.Precision.HIGHEST)
        use_f = jnp.einsum("k,kn->n", m_f.astype(row.dtype), eq_f,
                           preferred_element_type=row.dtype,
                           precision=jax.lax.Precision.HIGHEST) > 0.5
        row = jnp.where(use_f, vf, row)
        eq_b = (st - i[None, :] - 1) == k[:, None]
        vb = jnp.einsum("k,kn->n", jnp.where(m_b, val_b, 0.0), eq_b,
                        preferred_element_type=row.dtype,
                        precision=jax.lax.Precision.HIGHEST)
        use_b = jnp.einsum("k,kn->n", m_b.astype(row.dtype), eq_b,
                           preferred_element_type=row.dtype,
                           precision=jax.lax.Precision.HIGHEST) > 0.5
        row = jnp.where(use_b, vb, row)
        in_rng = (i >= r0) & (i <= r1)
        mean_f0 = jnp.sum(jnp.where(in_rng, row, 0.0)) / jnp.sum(in_rng)
        keep = valid & (threshold2 / mean_f0 < (r1 - r0))
        return row, r0, r1, keep

    rows, r0s, r1s, keeps = jax.vmap(extend_one)(starts, ends, sec_valid)

    # MergeF0 (harvest.py:442-486): kept sections sorted by extended start
    order = jnp.argsort(jnp.where(keeps, r0s, n + 10))
    rows = rows[order]
    r0s = jnp.asarray(r0s, jnp.int32)[order]
    r1s = jnp.asarray(r1s, jnp.int32)[order]
    keeps = keeps[order]
    merged0 = jnp.zeros(n, f0_step2.dtype)

    def merge_body(carry, sec):
        f0_m, cur_st, cur_ed, started = carry
        row, st2, ed2, keep = sec
        i = jnp.arange(n)

        def do_first(_):
            return row, st2, ed2, jnp.asarray(True)

        def do_merge(_):
            disjoint = (st2 - cur_ed) > 0

            # disjoint: copy section in, jump the current range
            f0_dis = jnp.where((i >= st2) & (i <= ed2), row, f0_m)

            # overlapping: MergeF0Sub (harvest.py:463-486)
            contained = (cur_st <= st2) & (cur_ed >= ed2)
            ov = (i >= st2) & (i <= cur_ed)

            def sscore(contour):
                # SerachScore: max score over candidates equal to the value
                eq = cands == contour[None, :]
                return jnp.max(jnp.where(eq, scores, 0.0), axis=0)

            s1 = jnp.sum(jnp.where(ov, sscore(f0_m), 0.0))
            s2 = jnp.sum(jnp.where(ov, sscore(row), 0.0))
            take2_from = jnp.where(s1 > s2, cur_ed, st2)
            f0_sub = jnp.where((i >= take2_from) & (i <= ed2), row, f0_m)
            f0_ovl = jnp.where(contained, f0_m, f0_sub)
            new_ed_ovl = jnp.where(contained, cur_ed, ed2)

            f0_new = jnp.where(disjoint, f0_dis, f0_ovl)
            st_new = jnp.where(disjoint, st2, cur_st)
            ed_new = jnp.where(disjoint, ed2, new_ed_ovl)
            return f0_new, st_new, ed_new, jnp.asarray(True)

        f0_new, st_new, ed_new, started_new = jax.lax.cond(
            keep & ~started, do_first,
            lambda _: jax.lax.cond(keep & started, do_merge,
                                   lambda __: (f0_m, cur_st, cur_ed, started),
                                   None), None)
        return (f0_new, st_new, ed_new, started_new), None

    (f0_merged, _, _, started), _ = jax.lax.scan(
        merge_body,
        (merged0, jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
         jnp.asarray(False)),
        (rows, r0s, r1s, keeps))
    return jnp.where(started, f0_merged, f0_step2)


def fix_step4(f0_step3, threshold: int = 9, max_sections: int = 1024):
    """Fill short unvoiced gaps by linear interpolation (harvest.py:388-404)."""
    n = f0_step3.shape[0]
    i = jnp.arange(n)
    v = (f0_step3 != 0) & (i > 0) & (i < n - 1)
    v_prev = jnp.concatenate([jnp.asarray([False]), v[:-1]])
    v_next = jnp.concatenate([v[1:], jnp.asarray([False])])
    is_start = v & ~v_prev
    is_end = v & ~v_next
    big = n + 10
    prev_end = jax.lax.cummax(jnp.where(is_end, i, -1))
    next_start = jax.lax.cummin(jnp.where(is_start, i, big)[::-1])[::-1]
    pe = jnp.concatenate([jnp.asarray([-1]), prev_end[:-1]])
    ns = jnp.concatenate([next_start[1:], jnp.asarray([big])])
    gap = ~v & (pe >= 0) & (ns < big)
    distance = ns - pe - 1
    tmp0 = jnp.take(f0_step3, jnp.clip(pe, 0, n - 1)) + 1
    tmp1 = jnp.take(f0_step3, jnp.clip(ns, 0, n - 1)) - 1
    c = (tmp1 - tmp0) / (distance + 1)
    fill = tmp0 + c * (i - pe)
    do = gap & (distance < threshold)
    return jnp.where(do, fill, f0_step3)


# ---------------------------------------------------------------------------
# SmoothF0 (harvest.py:533-559)
# ---------------------------------------------------------------------------

_SMOOTH_B = np.array([0.0078202080334971724, 0.015640416066994345,
                      0.0078202080334971724])
_SMOOTH_A = np.array([1.0, -1.7347257688092754, 0.76600660094326412])

# Zero-phase kernel radius.  The biquad's poles sit at radius
# sqrt(a2) = 0.875, so the impulse response at lag 300 is ~0.875^300 = 4e-18
# of its peak — below even float64 eps.  300 is the reference's OWN padding
# choice (harvest.py:536): it pads every section by 300 samples because the
# filter has forgotten everything older than that.
_SMOOTH_RADIUS = 300


def _smooth_zero_phase_kernel() -> np.ndarray:
    """(2R+1,) symmetric impulse response of SmoothF0's forward+backward
    biquad (harvest.py:550-559): g = h * reverse(h) with h the causal IR.

    On a constant-extended signal, lfilter-forward-then-backward IS
    convolution with g (LTI composition); the reference's zero initial state
    differs from the infinite-extension fixed point only by a transient that
    has decayed to ~1e-17 relative over its 300-sample pad — so the
    convolution form is numerically exact even against float64 goldens."""
    R = _SMOOTH_RADIUS
    h = np.zeros(R + 1)
    x = np.zeros(R + 1)
    x[0] = 1.0
    for i in range(R + 1):
        acc = _SMOOTH_B[0] * x[i]
        if i >= 1:
            acc += _SMOOTH_B[1] * x[i - 1] - _SMOOTH_A[1] * h[i - 1]
        if i >= 2:
            acc += _SMOOTH_B[2] * x[i - 2] - _SMOOTH_A[2] * h[i - 2]
        h[i] = acc
    return np.convolve(h, h[::-1])  # lags -R..R, symmetric


def smooth_f0(f0, max_sections: int = 256, section_chunk: int = 64):
    """Per-voiced-section zero-phase biquad smoothing (harvest.py:533-559).

    One batched FFT convolution instead of 4 associative-scan IIR passes per
    section: every section row (constant-extended, as in the reference) is
    convolved with the static symmetric zero-phase kernel in a
    (section_chunk, N) rfft/irfft pair, replacing a lax.map of log-depth
    IIR scans per section.  Kept outputs
    all sit >= R samples from both row ends (the reference's 300-pad), so
    circular wrap never contaminates them.

    The section axis is processed in ``section_chunk`` blocks via lax.scan so
    live memory stays O(section_chunk * n) — with the adaptive max_sections
    (~n/32, default_max_sections) a dense (max_sections, n) row matrix would
    be O(n^2/32): ~11 GB at 5 minutes of 16 kHz audio.  Sections are disjoint
    (at most one nonzero contribution per sample), so the blockwise
    accumulation is bitwise identical to the single-block sum."""
    n = f0.shape[0]
    R = _SMOOTH_RADIUS
    padded = jnp.concatenate([jnp.zeros(300, f0.dtype), f0, jnp.zeros(300, f0.dtype)])
    m = padded.shape[0]
    starts, ends, count = _sections(padded, max_sections)
    valid = jnp.arange(max_sections) < count

    
    N = int(2 ** np.ceil(np.log2(m + 2 * R)))
    g = _smooth_zero_phase_kernel()
    kern = np.zeros(N)
    kern[: R + 1] = g[R:]          # lags 0..R
    kern[-R:] = g[:R]              # lags -R..-1 wrap to the tail
    gf = jnp.asarray(np.fft.rfft(kern))
    gf = gf.astype(jnp.complex64 if f0.dtype == jnp.float32 else gf.dtype)
    i = jnp.arange(m)

    def block(st, ed, val):
        """Summed smoothed contribution (m,) of one (chunk,) section block."""
        in_sec = (i[None, :] >= st[:, None]) & (i[None, :] <= ed[:, None])
        c_st = jnp.take(padded, st)
        c_ed = jnp.take(padded, ed)
        rows = jnp.where(i[None, :] < st[:, None], c_st[:, None],
                         jnp.where(i[None, :] > ed[:, None], c_ed[:, None],
                                   padded[None, :]))
        out = jnp.fft.irfft(jnp.fft.rfft(rows, N) * gf, N)[:, :m]
        return jnp.sum(jnp.where(in_sec & val[:, None], out, 0.0), axis=0)

    if max_sections <= section_chunk:
        smoothed = block(starts, ends, valid)
    else:
        pad = (-max_sections) % section_chunk
        n_chunks = (max_sections + pad) // section_chunk

        def pad_r(a):
            return jnp.pad(a, (0, pad)).reshape(n_chunks, section_chunk)

        def body(acc, sc):
            st, ed, val = sc
            return acc + block(st, ed, val), None

        smoothed, _ = jax.lax.scan(
            body, jnp.zeros(m, f0.dtype),
            (pad_r(starts), pad_r(ends), pad_r(valid)))
    return smoothed[300 : m - 300]


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def default_max_sections(signal_length: int, fs) -> int:
    """Voiced-section table size scaled to the 1 ms basic frame count.

    Pre-merge sections can fragment to ~25/s on noisy inputs (measured on a
    60 s glide, where a fixed 256 saturated by ~11 s and zeroed all later
    voicing); floor at 256 so short inputs (incl. the 4.64 s golden fixture)
    keep the round-1 table shape.  Saturation still warns (_warn_capacity)."""
    num_samples = int(1000 * signal_length / fs + 1)
    return max(256, num_samples // 32 + 64)


def harvest(x, fs, f0_floor=71, f0_ceil=800, frame_period=5,
            max_candidates: int = None, max_sections: int = None,
            check_capacity: bool = True, debug_outputs: bool = False):
    """Harvest F0 estimation (API mirrors harvest.py:17-54).

    ``check_capacity`` fetches the on-device overflow flags (one small host
    sync) and warns if any static table (refinement slots, voiced-section
    tables) saturated — the reference's tables are unbounded
    (/root/reference/world/harvest.py:88-110), ours are static; saturation
    would silently drop candidates/sections without this check.
    """
    x = jnp.asarray(x)
    if max_candidates is None:
        # the reference's own cap: channels/10 rounded (harvest.py:90)
        n_bands = int(np.ceil(np.log2((f0_ceil * 1.1) / (f0_floor * 0.9)) * 40))
        max_candidates = int(n_bands / 10 + 0.5)
    if max_sections is None:
        max_sections = default_max_sections(x.shape[0], fs)
    out = _harvest_core(x, int(fs), float(f0_floor), float(f0_ceil),
                        float(frame_period), int(max_candidates),
                        int(max_sections), x.shape[0],
                        debug_outputs=debug_outputs)
    if check_capacity:
        _warn_capacity(out["_refine_overflow"], out["_section_overflow"],
                       max_sections)
    return {k: v for k, v in out.items()}


def _warn_capacity(refine_overflow, section_overflow, max_sections):
    """Surface static-table saturation (one small host sync for the flags)."""
    import warnings

    flags = np.asarray(jnp.stack([jnp.asarray(refine_overflow),
                                  jnp.asarray(section_overflow)]))
    if flags[0]:
        warnings.warn(
            "harvest: per-frame candidate count exceeded the refinement "
            "slot capacity (48); some candidates were dropped — results "
            "may degrade on this input", RuntimeWarning, stacklevel=3)
    if flags[1]:
        warnings.warn(
            f"harvest: voiced-section count exceeded max_sections="
            f"{max_sections}; extra sections were ignored — raise "
            f"max_sections", RuntimeWarning, stacklevel=3)


@partial(jax.jit, static_argnames=("fs", "f0_floor", "f0_ceil", "frame_period",
                                   "max_candidates", "max_sections",
                                   "signal_length", "debug_outputs"))
def _harvest_core(x, fs, f0_floor, f0_ceil, frame_period, max_candidates,
                  max_sections, signal_length, debug_outputs=False):
    """debug_outputs=True additionally returns every stage intermediate for
    the stage-golden tests; production callers leave it False so XLA
    dead-code-eliminates the full-shape scatter-backs and skips the
    device->host transfers of the (C, F) debug tensors."""
    target_fs = 8000
    basic_frame_period = 1
    num_samples = int(1000 * signal_length / fs / basic_frame_period + 1)
    basic_tp = jnp.asarray(np.arange(num_samples) * basic_frame_period / 1000,
                           dtype=x.dtype)
    channels_in_octave = 40
    adj_floor = f0_floor * 0.9
    adj_ceil = f0_ceil * 1.1
    boundary_f0_list = adj_floor * 2.0 ** (
        (np.arange(np.ceil(np.log2(adj_ceil / adj_floor) * channels_in_octave)) + 1)
        / channels_in_octave)

    y, actual_fs = downsample(x, fs, target_fs)
    y_len = y.shape[0]
    fft_size = int(2 ** np.ceil(np.log2(
        y_len + int(fs / adj_floor * 4 + 0.5) + 1)))
    duration = y_len / actual_fs
    capacity = int(duration * boundary_f0_list[-1] * 1.5) + 64

    # past ~27 s of 16 kHz audio, chunk the (independent) band axis so live
    # memory stays O(band_chunk * y_len); the threshold is correctness-
    # neutral (tests/test_robustness.py) and was sized for a 16 GB device
    band_chunk = 32 if y_len > 200_000 else None
    raw = raw_band_candidates(y, actual_fs, boundary_f0_list, basic_tp,
                              f0_floor, f0_ceil, fft_size, capacity,
                              band_chunk=band_chunk)
    cands0, n_detected = detect_candidates(raw, max_candidates)
    cands1 = overlap_candidates(cands0, max_candidates)
    max_half = int(np.ceil(3 * actual_fs / f0_floor / 2))
    # compact the sparse candidate grid (typically <32 nonzero of 7*mc rows
    # per frame) before the refinement fan-out.  Pure rank-select (the s-th
    # nonzero per frame via count_less + equality-masked select): exact value
    # copies fused into reduces — no (C2, C, F) one-hot tensor, no matmul
    from ..dsp.scanops import count_less_rows, select_rows_small

    C2 = min(48, cands1.shape[0])
    C = cands1.shape[0]
    nzT = (cands1 != 0).T                          # (F, C)
    rankT = jnp.cumsum(nzT.astype(jnp.int32), axis=1)  # 1-based rank per row
    pos = count_less_rows(rankT, jnp.arange(1, C2 + 1, dtype=jnp.int32))
    slot_valid = jnp.arange(1, C2 + 1)[None, :] <= rankT[:, -1:]
    compact = jnp.where(slot_valid,
                        select_rows_small(cands1.T, jnp.minimum(pos, C - 1)),
                        0.0).T                     # (C2, F)
    ref_c, score_c = refine_candidates(y, actual_fs, basic_tp, compact,
                                       f0_floor, f0_ceil, max_half,
                                       stride_samples=actual_fs * 0.001)
    # All downstream consumers (remove_unreliable, search_f0_base, the
    # SelectBestF0 reductions in fix_step3) treat a frame's candidate column
    # as a MULTISET: the compact (C2, F) grid holds the same nonzeros in the
    # same order and zeros behave identically (capped error 1, score 0), so
    # the contour stages run on the 2x-smaller compact grid.  The full-shape
    # (C, F) twins below exist only for stage-golden tests and are dead-code
    # eliminated unless requested.
    refine_overflow = jnp.max(rankT[:, -1]) > C2
    cands3, scores3 = remove_unreliable(ref_c, score_c)

    def scatter_back(sf):
        back_ok = nzT & (rankT <= C2)
        slot_idx = jnp.clip(rankT - 1, 0, C2 - 1)
        return jnp.where(back_ok, select_rows_small(sf.T, slot_idx), 0.0).T

    f0_base = search_f0_base(cands3, scores3)
    f0_step1 = fix_step1(f0_base, 0.008)
    f0_step2 = fix_step2(f0_step1, 6)
    f0_step3 = fix_step3(f0_step2, cands3, scores3, 0.18,
                         max_sections=max_sections)
    f0_step4 = fix_step4(f0_step3, 9)
    vuv_full = jnp.where(f0_step4 != 0, 1.0, 0.0)
    smoothed = smooth_f0(f0_step4, max_sections=max_sections)

    # capacity checks: number of voiced sections actually present at the two
    # section-table consumers (fix_step3 input, smooth_f0 input); the static
    # tables silently ignore sections past max_sections, so surface it
    def _n_sections(f):
        v = f != 0
        return jnp.sum(v & ~jnp.concatenate([jnp.zeros(1, bool), v[:-1]]))

    section_overflow = jnp.maximum(_n_sections(f0_step2),
                                   _n_sections(f0_step4)) > max_sections

    out_samples = int(1000 * signal_length / fs / frame_period + 1)
    tp_out = jnp.asarray(np.arange(out_samples) * frame_period / 1000,
                         dtype=x.dtype)
    idx = jnp.minimum(smoothed.shape[0] - 1,
                      matlab_round_half(tp_out * 1000)).astype(jnp.int32)
    out = {
        "temporal_positions": tp_out,
        "f0": jnp.take(smoothed, idx),
        "vuv": jnp.take(vuv_full, idx),
        "_refine_overflow": refine_overflow,
        "_section_overflow": section_overflow,
    }
    if debug_outputs:
        out.update({
            "_raw_candidates": raw,
            "_cands_detected": cands0,
            "_cands_overlap": cands1,
            "_cands_refined": scatter_back(ref_c),
            "_scores_refined": scatter_back(score_c),
            "_cands_clean": scatter_back(cands3),
            "_scores_clean": scatter_back(scores3),
            "_f0_base": f0_base,
            "_f0_step1": f0_step1,
            "_f0_step2": f0_step2,
            "_f0_step3": f0_step3,
            "_f0_step4": f0_step4,
            "_smoothed": smoothed,
        })
    return out
