"""SWIPE' pitch estimator — a static-matmul reformulation.

Mirrors /root/reference/world/swipe.py:9-169 semantically.  The design
collapses the whole pipeline into static matmuls:

  * multi-resolution STFTs are framed batched rFFTs (one per octave, static
    shapes);
  * the cubic-spline resampling onto the ERB grid is precomputed HOST-SIDE
    as a linear operator (spline interpolation is linear in the samples), so
    on device it is ONE (nERB x nFreq) matmul per octave;
  * the prime-harmonic pitch-strength kernels are a static (nCand x nERB)
    matrix -> another matmul;
  * the octave blending weights (lambda/mu) are static masks;
  * the final parabolic fine-tuning exploits the log-spaced grid: the
    3-point abscissae ratios are constant across candidates, so one static
    17-point fine grid serves every frame (exact closed-form parabola
    instead of polyfit).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..dsp.windows import np_hanning_matlab


def _hz2erbs(hz):
    return 21.4 * np.log10(1 + hz / 229.0)


def _erbs2hz(erbs):
    return (10 ** (erbs / 21.4) - 1) * 229.0


def _primes(n):
    if n < 2:
        return []
    sieve = np.ones(n + 1, bool)
    sieve[:2] = False
    for p in range(2, int(n ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p :: p] = False
    return list(np.nonzero(sieve)[0])


def _kernel_matrix(fERBs, pc):
    """pitchStrengthOneCandidate for all candidates (swipe.py:126-145)."""
    K = np.zeros((len(pc), len(fERBs)))
    for j, p in enumerate(pc):
        n = int(np.fix(fERBs[-1] / p - 0.75))
        k = np.zeros(len(fERBs))
        q = fERBs / p
        for i in [1] + _primes(n):
            a = np.abs(q - i)
            pk = a < 0.25
            k[pk] = np.cos(2 * np.pi * q[pk])
            v = (0.25 < a) & (a < 0.75)
            k[v] += np.cos(2 * np.pi * q[v]) / 2
        k *= np.sqrt(1.0 / fERBs)
        k /= np.linalg.norm(k[k > 0])
        K[j] = k
    return K


@functools.lru_cache(maxsize=4)
def _static_config(fs: int, plim: tuple, dlog2p: float, dERBs: float, K: int):
    log2pc = np.arange(np.log2(plim[0]) * 96, np.log2(plim[-1]) * 96) * dlog2p
    pc = 2.0 ** log2pc
    logWs = [int(math.floor(v + 0.5)) for v in np.log2(4 * K * fs / np.asarray(plim))]
    ws = (2 ** np.arange(logWs[0], logWs[1] - 1, -1)).astype(int)
    p0 = 4 * K * fs / ws
    d = 1 + log2pc - np.log2(4 * K * fs / ws[0])
    fERBs = _erbs2hz(np.arange(_hz2erbs(pc[0] / 4), _hz2erbs(fs / 2), dERBs))

    per_octave = []
    for i, w in enumerate(ws):
        freqs = np.arange(w // 2 + 1) * fs / w
        # cubic-spline resampling fERBs <- freqs as a static linear operator
        from scipy.interpolate import interp1d

        A = interp1d(freqs, np.eye(len(freqs)), kind="cubic", axis=-1)(fERBs)
        # A[k, e]: weight of freq-bin k for ERB point e
        # candidate selection masks (swipe.py:45-62) — d is static
        if i == len(ws) - 1:
            j = np.nonzero(d - (i + 1) > -1)[0]
            kk = np.nonzero(d[j] - (i + 1) < 0)[0]
        elif i == 0:
            j = np.nonzero(d - (i + 1) < 1)[0]
            kk = np.nonzero(d[j] - (i + 1) > 0)[0]
        else:
            j = np.nonzero(np.abs(d - (i + 1)) < 1)[0]
            kk = np.arange(len(j))
        mu = np.ones(len(j))
        mu[kk] = 1 - np.abs(d[j[kk]] - (i + 1))
        Kmat = _kernel_matrix(fERBs, pc[j])
        win = np_hanning_matlab(w)  # np.hanning(w+2)[1:-1]
        per_octave.append(dict(ws=int(w), dn=int(math.floor(4 * fs / p0[i] + 0.5)),
                               A=A, j=j, mu=mu, K=Kmat, win=win))
    return dict(pc=pc, log2pc=log2pc, per_octave=per_octave, fERBs=fERBs)


def swipe(fs, x, plim=(71, 800), dt=0.005, sTHR=float("-inf")):
    """SWIPE' F0 estimation (API mirrors swipe.py:9-102)."""
    x = jnp.asarray(x)
    cfg = _static_config(int(fs), tuple(plim), 1 / 96, 0.1, 2)
    num_samples = int(1000 * x.shape[0] / fs / (dt * 1000) + 1)
    t = np.arange(num_samples) * dt
    return _swipe_core(x, cfg, float(fs), jnp.asarray(t, x.dtype), float(sTHR))


def _swipe_core(x, cfg, fs, t, sTHR):
    dtype = x.dtype
    pc = cfg["pc"]
    n_cand = len(pc)
    n_t = t.shape[0]
    S = jnp.zeros((n_cand, n_t), dtype)

    for oct_cfg in cfg["per_octave"]:
        w, dn = oct_cfg["ws"], oct_cfg["dn"]
        xzp = jnp.concatenate([jnp.zeros(w // 2, dtype), x,
                               jnp.zeros(dn + w // 2, dtype)])
        n_frames = (xzp.shape[0] - w) // dn + 1
        starts = np.arange(n_frames) * dn
        idx = starts[:, None] + np.arange(w)[None, :]
        frames = xzp[jnp.asarray(idx)] * jnp.asarray(oct_cfg["win"], dtype)
        X = jnp.abs(jnp.fft.rfft(frames))                     # (frames, bins)
        hp = jax.lax.Precision.HIGHEST
        M = jnp.maximum(0.0, jnp.dot(X, jnp.asarray(oct_cfg["A"], dtype),
                                     precision=hp,
                                     preferred_element_type=dtype))  # ERB grid
        L = jnp.sqrt(M)                                      # (frames, nERB)
        den = jnp.sqrt(jnp.sum(L * L, axis=1, keepdims=True))
        den = jnp.where(den == 0, 2.220446049250313e-16, den)
        Ln = L / den
        Si = jnp.dot(Ln, jnp.asarray(oct_cfg["K"], dtype).T, precision=hp,
                     preferred_element_type=dtype)           # (frames, nCand_j)

        # time interp (linear, NaN outside) from the shifted frame times
        # ti = [0, (arange(n_frames-1)*dn + w/2)/fs]  (swipe.py:37-39)
        ti = np.r_[0.0, (np.arange(n_frames - 1) * dn + w / 2) / fs]
        ti_j = jnp.asarray(ti, dtype)
        pos = jnp.searchsorted(ti_j, t, side="right") - 1
        pos = jnp.clip(pos, 0, n_frames - 2)
        t0 = ti_j[pos]
        t1 = ti_j[pos + 1]
        frac = (t - t0) / (t1 - t0)
        Si_t = Si[pos] * (1 - frac[:, None]) + Si[pos + 1] * frac[:, None]
        outside = (t < ti_j[0]) | (t > ti_j[-1])
        Si_t = jnp.where(outside[:, None], jnp.nan, Si_t)    # (n_t, nCand_j)

        contribution = jnp.asarray(oct_cfg["mu"], dtype)[:, None] * Si_t.T
        # the candidate subsets j are contiguous ranges (interval conditions
        # on the monotone octave distance d, swipe.py:45-62) -> a static
        # slice-add instead of a gather/scatter pair
        j = np.asarray(oct_cfg["j"])
        assert np.array_equal(j, np.arange(j[0], j[0] + len(j))), j
        S = S.at[int(j[0]) : int(j[0]) + len(j)].add(contribution)

    # parabolic fine-tuning on the log-spaced grid (swipe.py:64-93)
    s_max = jnp.max(S, axis=0)
    imax = jnp.argmax(S, axis=0)
    i_c = jnp.clip(imax, 1, n_cand - 2)
    y0 = jnp.take_along_axis(S, (i_c - 1)[None, :], axis=0)[0]
    y1 = jnp.take_along_axis(S, i_c[None, :], axis=0)[0]
    y2 = jnp.take_along_axis(S, (i_c + 1)[None, :], axis=0)[0]

    # abscissae: ntc = (tc/tc[1]-1)*2pi with tc = 1/pc[I]; ratios constant
    r = 2.0 ** (1.0 / 96)
    ntc = jnp.asarray([(r - 1) * 2 * np.pi, 0.0, (1 / r - 1) * 2 * np.pi], dtype)
    # exact parabola through the 3 points (replaces np.polyfit deg 2)
    x0_, x1_, x2_ = ntc[0], ntc[1], ntc[2]
    denom = (x0_ - x1_) * (x0_ - x2_) * (x1_ - x2_)
    a_c = (x2_ * (y1 - y0) + x1_ * (y0 - y2) + x0_ * (y2 - y1)) / denom
    b_c = (x2_ ** 2 * (y0 - y1) + x1_ ** 2 * (y2 - y0) + x0_ ** 2 * (y1 - y2)) / denom
    c_c = y1  # at x1_ = 0 the parabola passes through y1

    # fine grid: ftc over [log2 pc[i-1], log2 pc[i+1]] step 1/12/64 (17 pts)
    step = 1.0 / 12 / 64
    n_fine = int(np.floor((2.0 / 96) / step)) + 1
    klog = jnp.asarray(np.arange(n_fine) * step, dtype)      # relative log2
    # nftc = (ftc/tc[1]-1)*2pi, ftc = 2^-(log2 pc[i-1] + klog) * ... ratio:
    nftc = (2.0 ** (1.0 / 96 - klog) - 1.0) * 2 * np.pi
    pval = (a_c[:, None] * nftc[None, :] ** 2 + b_c[:, None] * nftc[None, :]
            + c_c[:, None])
    kbest = jnp.argmax(pval, axis=1)
    s_fine = jnp.max(pval, axis=1)
    log2pc = jnp.asarray(cfg["log2pc"], dtype)
    p_fine = 2.0 ** (log2pc[i_c - 1] + kbest * step)

    pc_j = jnp.asarray(pc, dtype)
    p = jnp.where((imax == 0) | (imax == n_cand - 1), pc_j[0], p_fine)
    s_out = jnp.where((imax == 0) | (imax == n_cand - 1), s_max, s_fine)
    ok = ~(s_max < sTHR) & jnp.isfinite(p) & ~jnp.isnan(s_max)
    f0 = jnp.where(ok, p, 0.0)
    f0 = jnp.where(jnp.isnan(f0), 0.0, f0)
    vuv = jnp.where(f0 > 0, 1.0, 0.0)
    return {"temporal_positions": t, "f0": f0, "vuv": vuv}
