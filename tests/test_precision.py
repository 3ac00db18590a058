"""Precision policy: every float32 matrix product or convolution on the main
paths names its precision.

On the GPU an f32 dot left at DEFAULT precision may run in TF32 (about three
decimal digits), which flips Harvest's near-tied candidate decisions.  The
CPU cannot show TF32, so this test reads the programs instead: it traces the
pipelines at tiny float32 shapes (x64 off, as on the card) and walks every
jaxpr, including the bodies of scans, conds, jits and custom_vmap calls.
"""
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.extend.core import ClosedJaxpr, Jaxpr

FS, N = 12000, 3072
_CHECKED = ("dot_general", "conv_general_dilated")


def _sub_jaxprs(value):
    if isinstance(value, ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _unpinned(jaxpr, found):
    """Collect (primitive, operand dtypes) of every float32 dot/conv whose
    precision is unset or DEFAULT, recursively."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in _CHECKED:
            dtypes = [v.aval.dtype for v in eqn.invars]
            prec = eqn.params.get("precision")
            if isinstance(prec, tuple):
                named = any(p not in (None, jax.lax.Precision.DEFAULT)
                            for p in prec)
            else:
                named = prec not in (None, jax.lax.Precision.DEFAULT)
            if jnp.float32 in dtypes and not named:
                found.append((eqn.primitive.name, dtypes,
                              str(eqn.source_info.name_stack)))
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                _unpinned(sub, found)
    return found


def _signal():
    t = np.arange(N) / FS
    rng = np.random.RandomState(0)
    return jnp.asarray((0.6 * np.sin(2 * np.pi * 150 * t)
                        + 0.01 * rng.randn(N)).astype(np.float32))


def _requiem_path():
    from world_tpu.parallel.batch import _encode_decode_one
    from world_tpu.synth.seeds import get_seeds_signals

    seeds = get_seeds_signals(FS)
    pulse = jnp.asarray(np.asarray(seeds["pulse"], np.float32))
    noise = jnp.asarray(np.asarray(seeds["noise"], np.float32))
    fn = partial(_encode_decode_one, fs=FS, frame_period=10, max_pulses=256,
                 max_candidates=8, max_sections=16)
    return fn, (_signal(), pulse, noise)


def _classic_path():
    from world_tpu.parallel.batch import _encode_decode_classic_one

    fn = partial(_encode_decode_classic_one, fs=FS, frame_period=10)
    return fn, (_signal(), jax.random.PRNGKey(0))


def _swipe_path():
    from world_tpu.f0.swipe import swipe

    return (lambda x: swipe(FS, x, plim=[71, 800], sTHR=0.3)), (_signal(),)


@pytest.mark.parametrize("path", [_requiem_path, _classic_path, _swipe_path],
                         ids=["harvest_requiem", "dio_classic", "swipe"])
def test_float32_products_name_their_precision(path):
    with jax.enable_x64(False):
        fn, args = path()
        closed = jax.make_jaxpr(fn)(*args)
        found = _unpinned(closed.jaxpr, [])
    n_checked = sum(1 for _ in _iter_checked(closed.jaxpr))
    assert n_checked > 0, "traced program holds no dot/conv to check"
    assert not found, f"float32 products without a precision: {found}"


def _iter_checked(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in _CHECKED:
            yield eqn
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                yield from _iter_checked(sub)


def test_walker_flags_an_unpinned_dot():
    """The walker itself: a DEFAULT f32 dot nested in a scan is reported."""
    def body(c, x):
        return c + jnp.dot(x, x), None

    with jax.enable_x64(False):
        closed = jax.make_jaxpr(
            lambda xs: jax.lax.scan(body, jnp.zeros((2, 2)), xs))(
                jnp.ones((3, 2, 2), jnp.float32))
    assert len(_unpinned(closed.jaxpr, [])) == 1
