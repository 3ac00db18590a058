"""Float32 numerics helpers and the hand-written kernels of the hot stages.

Each kernel (``ops.refine_dft``) has a plain-XLA twin that serves as the CPU
path and as the test oracle; which one runs is chosen by the backend.
"""
import numpy as np


def _split3_f32(a):
    """Exact 3-term bf16 decomposition of an f32 array: a == hi + mid + lo.

    Each residual holds <=8 leftover mantissa bits, so every cast is exact
    and the three bf16 terms reconstruct the f32 value bit-for-bit."""
    import jax.numpy as jnp

    hi = a.astype(jnp.bfloat16)
    r1 = a - hi.astype(jnp.float32)
    mid = r1.astype(jnp.bfloat16)
    lo = (r1 - mid.astype(jnp.float32)).astype(jnp.bfloat16)
    return hi, mid, lo


def dot_exact_b(a, b):
    """a @ b where ``b`` is exactly bf16-representable (e.g. a 0/1 one-hot
    matrix): three bf16 dots with float32 accumulation whose sum reproduces
    the full-f32 product exactly (each bf16 x bf16 product is exact in f32).
    Non-f32 dtypes take a plain dot."""
    import jax
    import jax.numpy as jnp

    if a.dtype != jnp.float32:
        return jax.lax.dot(a, b, preferred_element_type=a.dtype)
    bb = b.astype(jnp.bfloat16)
    out = None
    for part in _split3_f32(a):
        d = jax.lax.dot(part, bb, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.DEFAULT)
        out = d if out is None else out + d
    return out


def prod_diff(a, b, c, d):
    """Compensated ``a*b - c*d`` for f32 (identity for other dtypes).

    The instantaneous-frequency numerator ``re_s*im_d - im_s*re_d``
    (reference GetRefinedF0, /root/reference/world/harvest.py:194-207) is a
    cancellation-prone difference of products: naive f32 leaves ~2^-24
    relative noise OF THE PRODUCTS, which near-ties in the candidate scores
    turn into argmax flips (whole spurious voiced sections at 16 kHz).

    Exact 3-term bf16 splits (``_split3_f32``) make every pairwise partial
    product exact in f32 (8+8 mantissa bits < 24), so the only rounding is
    in the 9 pair differences and their small-first summation — total error
    ~2^-32 of the product magnitude, ~256x tighter than the naive form.
    bf16 casts also cannot be contracted away by the compiler (unlike a
    Veltkamp split, whose mul/sub pattern XLA may FMA-fuse)."""
    import jax.numpy as jnp

    if a.dtype != jnp.float32:
        return a * b - c * d
    f32 = jnp.float32
    sa, sb = _split3_f32(a), _split3_f32(b)
    sc, sd = _split3_f32(c), _split3_f32(d)
    # pair differences by split level; sum smallest-magnitude level first
    levels = {}
    for i in range(3):
        for j in range(3):
            t = (sa[i].astype(f32) * sb[j].astype(f32)
                 - sc[i].astype(f32) * sd[j].astype(f32))
            levels.setdefault(i + j, []).append(t)
    acc = None
    for k in sorted(levels, reverse=True):
        for t in levels[k]:
            acc = t if acc is None else acc + t
    return acc


_PI_HI = 3.1416015625           # 12-bit-truncated pi: k*_PI_HI exact, |k|<=4
_PI_LO1 = -8.908910206761537e-06
_PI_LO2 = -3.3040238729429614e-13


def cos_reduced(u):
    """cos(u) for |u| <= ~4*pi: Cody-Waite reduction (3-term pi split) +
    a degree-10 even minimax polynomial on [-pi/2, pi/2].

    Max abs error 1.8e-7 over |u| <= 2.3*pi — f32-cos grade (np.cos f32 is
    1.4e-7).  Window noise is amplified ~16x into Harvest's candidate
    scores, so a looser polynomial (~2e-6) flips near-tied candidates."""
    import jax.numpy as jnp

    k = jnp.round(u * (1.0 / np.pi))
    r = ((u - k * _PI_HI) - k * _PI_LO1) - k * _PI_LO2
    t = r * r
    c = (9.999999997522e-01, -4.999999929029e-01, 4.166663371258e-02,
         -1.388832879127e-03, 2.475848205674e-05, -2.602158942983e-07)
    acc = c[5]
    for i in (4, 3, 2, 1, 0):
        acc = acc * t + c[i]
    # (-1)^k without integer ops: frac(k/2) is 0 (even) or 0.5 (odd)
    half = k * 0.5
    sign = 1.0 - 4.0 * (half - jnp.floor(half))
    return sign * acc
