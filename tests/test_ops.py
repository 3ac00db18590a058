"""Refinement kernel and float32 numerics helpers.

The Triton kernel runs in interpreter mode here (tests run on the CPU
backend); on the GPU the same kernel code compiles through Triton.  Both it
and its plain-XLA twin are held to a float64 NumPy GetRefinedF0.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.smoke

FS8K = 7350.0          # harvest's decimated rate for 22.05 kHz input


def _kernel_inputs(rng, C, B, W, f0_lo=80.0, f0_hi=780.0, actual_fs=FS8K):
    """Random float32 (seg, phase, f0) at a window width W; slot 0 holds a
    few empty candidates and slot C-1 is empty throughout (skipped tiles)."""
    max_half = (W - 1) // 2
    seg = jnp.asarray(rng.randn(B, W), jnp.float32)
    phase = np.broadcast_to((np.arange(W) - max_half - 0.499) / actual_fs,
                            (B, W)).copy()
    phase[:3] -= 1.0 / actual_fs                     # first-frame clamp branch
    f0 = rng.rand(C, B) * (f0_hi - f0_lo) + f0_lo
    f0[0, :7] = 1e-12
    f0[-1] = 1e-12
    return (seg, jnp.asarray(phase, jnp.float32),
            jnp.asarray(f0, jnp.float32), max_half)


def _assert_refine_close(got, want, tag=""):
    """float32 kernel vs float32 twin: the two sum the same products in a
    different order, so values agree to f32 rounding and every accept/reject
    decision is identical on these inputs.  The score is 1/variation, which
    amplifies that rounding ~10x (the float32 twin's own score error against
    float64 reaches 5e-5 relative)."""
    for g, w, rtol in zip(got, want, (2e-5, 2e-4)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        np.testing.assert_array_equal(g != 0, w != 0, err_msg=tag)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-4, err_msg=tag)


def test_refine_triton_matches_xla():
    from world_tpu.ops.refine_dft import (_refine_triton, dft_basis,
                                          refine_full_xla)

    rng = np.random.RandomState(0)
    C, B, W = 5, 200, 45                      # B not a multiple of the tile
    nb = 33                                   # S = 64
    seg, phase, f0, max_half = _kernel_inputs(rng, C, B, W)
    got = _refine_triton(seg, phase, f0, FS8K, max_half, nb, 71.0, 800.0,
                         interpret=True)
    want = refine_full_xla(seg, phase, f0, dft_basis(W, nb, jnp.float32),
                           FS8K, max_half, nb, 71.0, 800.0)
    assert got[0].shape == got[1].shape == (C, B)
    assert int(np.sum(np.asarray(want[0]) != 0)) > 300
    _assert_refine_close(got, want)


def test_refine_triton_custom_vmap_folds_batch():
    """vmap over an utterance batch must fold into the frame-row axis and
    reproduce each example's unbatched kernel result exactly (rows are
    independent, so regrouping rows into tiles cannot change the math)."""
    from world_tpu.ops.refine_dft import _refine_triton_batchable

    rng = np.random.RandomState(3)
    N, C, B, W = 3, 4, 150, 45
    segs, f0s = [], []
    for _ in range(N):
        seg, phase, f0, max_half = _kernel_inputs(rng, C, B, W)
        segs.append(seg)
        f0s.append(f0)
    seg, f0 = jnp.stack(segs), jnp.stack(f0s)       # phase stays unbatched
    fn = _refine_triton_batchable(FS8K, max_half, 33, 71.0, 800.0,
                                  interpret=True)
    got_f0, got_sc = jax.vmap(fn, in_axes=(0, None, 0))(seg, phase, f0)
    for i in range(N):
        want_f0, want_sc = fn(seg[i], phase, f0[i])
        np.testing.assert_array_equal(np.asarray(got_f0[i]),
                                      np.asarray(want_f0))
        np.testing.assert_array_equal(np.asarray(got_sc[i]),
                                      np.asarray(want_sc))


def test_refine_bucketed_matches_single_block():
    """The f0-bucketed refinement fan-out must reproduce the single-bucket
    result: smaller bases share the bin angles (K/S == bins/fft) and
    dropped columns are masked-zero window samples."""
    from world_tpu.f0.harvest import (_bucket_caps, _refine_block,
                                      _refine_bucketed)

    rng = np.random.RandomState(11)
    actual_fs = FS8K
    max_half = int(np.ceil(3 * actual_fs / 71.0 / 2))
    W = 2 * max_half + 1
    C2, F = 12, 300
    assert len(_bucket_caps(max_half)) >= 3
    seg = jnp.asarray(rng.randn(F, W))
    t_c = jnp.asarray(np.arange(F) / 1000.0)
    f0 = rng.rand(C2, F) * 720 + 75
    f0[rng.rand(C2, F) < 0.5] = 0.0          # sparse slots
    f0[0, :4] = 1e-12                        # degenerate rows stay masked
    cands = jnp.asarray(f0)
    want = _refine_block(seg, t_c, cands, actual_fs, 71.0, 800.0, max_half)
    got = _refine_bucketed(seg, t_c, cands, actual_fs, 71.0, 800.0, max_half)
    # smaller DFTs sum the same nonzero terms in another order: last-ulp noise
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("bucket", range(4))
def test_refine_triton_at_bucket_shapes(bucket):
    """The kernel must stay correct at every production bucket size (the
    f0-bucketed fan-out instantiates it at shrinking (W, S), which pad to
    different power-of-two tiles)."""
    from world_tpu.f0.harvest import _bucket_caps
    from world_tpu.ops.refine_dft import (_refine_triton, dft_basis,
                                          refine_full_xla)

    caps = _bucket_caps(int(np.ceil(3 * FS8K / 71.0 / 2)))
    assert len(caps) == 4
    cap = caps[bucket]
    W = 2 * cap + 1
    S = int(2 ** np.ceil(np.log2(W) + 1))
    nb = S // 2 + 1
    # only candidates whose window fits this cap are routed to it
    f0_min = 3.0 * FS8K / (2.0 * cap)
    rng = np.random.RandomState(7 + bucket)
    seg, phase, f0, _ = _kernel_inputs(rng, 4, 150, W, f0_lo=f0_min,
                                       f0_hi=790.0)
    got = _refine_triton(seg, phase, f0, FS8K, cap, nb, 71.0, 800.0,
                         interpret=True)
    want = refine_full_xla(seg, phase, f0, dft_basis(W, nb, jnp.float32),
                           FS8K, cap, nb, 71.0, 800.0)
    _assert_refine_close(got, want, tag=f"cap={cap}")


def test_refine_matches_numpy_get_refined_f0():
    """The whole refinement stage (compaction grid -> f0 buckets -> twin)
    against the float64 NumPy GetRefinedF0, row by row, in float64."""
    from world_tpu.f0.harvest import refine_candidates
    from world_tpu.ops.refine_dft import get_refined_f0_np

    rng = np.random.RandomState(5)
    fs = 8000.0
    n = 2400                                   # 0.3 s
    t = np.arange(n) / fs
    f_true = 120.0 + 60.0 * t / t[-1]
    y = (np.sin(2 * np.pi * np.cumsum(f_true) / fs)
         + 0.4 * np.sin(4 * np.pi * np.cumsum(f_true) / fs)
         + 0.05 * rng.randn(n))
    F = int(1000 * n / fs) + 1
    tp = np.arange(F) / 1000.0
    cands = np.zeros((6, F))
    cands[0] = np.interp(tp, t, f_true) * (1 + 0.01 * rng.randn(F))
    cands[1] = cands[0] * 2
    cands[2] = rng.rand(F) * 700 + 75
    cands[3, ::3] = rng.rand(len(cands[3, ::3])) * 700 + 75
    max_half = int(np.ceil(3 * fs / 71.0 / 2))
    ref, score = refine_candidates(jnp.asarray(y), fs, jnp.asarray(tp),
                                   jnp.asarray(cands), 71.0, 800.0, max_half,
                                   stride_samples=fs * 0.001)
    ref, score = np.asarray(ref), np.asarray(score)
    rows = [(c, q) for c in range(4) for q in range(0, F, 7) if cands[c, q]]
    for c, q in rows:
        want = get_refined_f0_np(y, fs, tp[q], cands[c, q], 71.0, 800.0)
        np.testing.assert_allclose((ref[c, q], score[c, q]), want,
                                   rtol=1e-7, atol=1e-9, err_msg=(c, q))
    assert np.all(ref[4:] == 0) and np.all(score[4:] == 0)
    assert sum(ref[c, q] != 0 for c, q in rows) > 50


@pytest.mark.parametrize("backend,dtype,want", [
    ("gpu", jnp.float32, "triton"),
    ("gpu", jnp.float64, "xla"),
    ("cpu", jnp.float32, "xla"),
    ("cpu", jnp.float64, "xla"),
])
def test_refine_impl_by_backend(backend, dtype, want):
    """The kernel is chosen by backend and dtype, explicitly: the GPU runs
    the Triton kernel in float32 and nothing falls back to it silently."""
    from world_tpu.ops.refine_dft import refine_impl

    assert refine_impl(backend, dtype) == want


def test_refine_full_runs_twin_on_cpu(monkeypatch):
    """On the CPU backend refine_full never reaches the kernel."""
    from world_tpu.ops import refine_dft

    def boom(*a, **k):
        raise AssertionError("kernel called on the CPU backend")

    monkeypatch.setattr(refine_dft, "_refine_triton_batchable", boom)
    rng = np.random.RandomState(1)
    seg, phase, f0, max_half = _kernel_inputs(rng, 3, 40, 45)
    r, s = refine_dft.refine_full(seg, phase, f0, FS8K, max_half, 33, 71.0,
                                  800.0)
    assert r.shape == s.shape == (3, 40)


@pytest.mark.gpu
def test_refine_triton_compiled_matches_xla(gpu):
    """On the card: the compiled kernel at the 16 kHz real width (W=341,
    S=1024) against the twin run on the same card."""
    from world_tpu.ops.refine_dft import (_refine_triton, dft_basis,
                                          refine_full_xla)

    rng = np.random.RandomState(2)
    C, B, W, nb, fs = 8, 1000, 341, 513, 8000.0
    seg, phase, f0, max_half = _kernel_inputs(rng, C, B, W, actual_fs=fs)
    got = _refine_triton(seg, phase, f0, fs, max_half, nb, 71.0, 800.0)
    want = refine_full_xla(seg, phase, f0, dft_basis(W, nb, jnp.float32), fs,
                           max_half, nb, 71.0, 800.0)
    _assert_refine_close(got, want, tag=str(gpu))


def test_prod_diff_compensated_f32():
    """ops.prod_diff must beat naive f32 a*b-c*d by >=100x on cancellation-
    heavy inputs and pass through f64 untouched (the CPU golden path)."""
    import jax

    from world_tpu.ops import prod_diff

    rng = np.random.RandomState(0)
    a64 = rng.randn(50000) * 10
    b64 = rng.randn(50000) * 10
    c64 = a64 * (1 + rng.randn(50000) * 1e-6)
    d64 = b64 * (1 + rng.randn(50000) * 1e-6)
    a, b, c, d = (jnp.asarray(v, jnp.float32) for v in (a64, b64, c64, d64))
    exact = (np.asarray(a, np.float64) * np.asarray(b, np.float64)
             - np.asarray(c, np.float64) * np.asarray(d, np.float64))
    scale = np.abs(a64 * b64) + 1e-30
    naive = np.asarray(jax.jit(lambda a, b, c, d: a * b - c * d)(a, b, c, d))
    comp = np.asarray(jax.jit(prod_diff)(a, b, c, d))
    err_naive = np.max(np.abs(naive - exact) / scale)
    err_comp = np.max(np.abs(comp - exact) / scale)
    assert err_comp * 100 < err_naive, (err_comp, err_naive)

    a, b, c, d = (jnp.asarray(v) for v in (a64, b64, c64, d64))
    want = np.asarray(jax.jit(lambda a, b, c, d: a * b - c * d)(a, b, c, d))
    got = np.asarray(jax.jit(prod_diff)(a, b, c, d))
    assert np.array_equal(want, got)


def test_cos_reduced_f32_cos_grade():
    """ops.cos_reduced must hold f32-cos-grade accuracy (<= 3e-7 abs) over
    both window-argument ranges (|u| <= 1.15*pi for the Blackman c2 term,
    |u| <= 2.3*pi for c4) — a looser bounded polynomial (~2e-6 real f32
    error) was enough to flip near-tied Harvest candidate scores."""
    import jax

    from world_tpu.ops import cos_reduced

    for span in (1.15 * np.pi, 2.3 * np.pi):
        u64 = np.linspace(-span, span, 200001)
        u = jnp.asarray(u64, jnp.float32)
        got = np.asarray(jax.jit(cos_reduced)(u), np.float64)
        want = np.cos(np.asarray(u, np.float64))
        assert np.abs(got - want).max() < 3e-7, span
