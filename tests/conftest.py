"""Test configuration: run JAX on a virtual 8-device CPU mesh with float64.

The golden tests compare against the NumPy reference (float64), so tests run
with ``jax_enable_x64``.  The library itself is dtype-polymorphic: on the GPU
the same code paths run in float32 (see chip_smoke.py).
"""
import os
from pathlib import Path

# Must be set before jax is imported anywhere.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# persistent compilation cache: the pipeline cores are large programs and
# recompiling them every pytest run dominates suite wall time
from world_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

GOLDEN = Path(__file__).parent / "golden"
MWM_WAV = Path("/root/reference/test/test-mwm.wav")


@pytest.fixture(scope="session")
def mwm():
    """The reference fixture waveform (22050 Hz mono float64 in [-1, 1)).

    It lives in the reference checkout, not in this repository; tests that
    need it skip when it is absent."""
    if not MWM_WAV.exists():
        pytest.skip(f"reference fixture {MWM_WAV} is not present")
    from scipy.io import wavfile

    fs, x = wavfile.read(str(MWM_WAV))
    # normalization used by the reference's own scripts (example/prosody.py:13)
    return fs, x.astype(np.float64) / (2 ** 15 - 1)


@pytest.fixture(scope="session")
def speech16k():
    """The in-repo speech fixture: (16000, x16) from harvest_16k.npz
    (4.644 s, float64)."""
    g = np.load(GOLDEN / "harvest_16k.npz")
    return int(g["fs"]), np.asarray(g["x16"], np.float64)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU (decided here,
    at run time, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend; run on the card by chip_smoke.py")
    return jax.devices()[0]
