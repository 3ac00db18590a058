"""Float64 goldens for the DIO+StoneMask and SWIPE' paths at 16 kHz.

The input is ``x16`` from tests/golden/harvest_16k.npz (4.644 s of speech at
16 kHz), the only speech the repository carries.  The NumPy reference these
paths were rebuilt from is not part of the repository, so the oracle is this
package run in float64 on the CPU; at 22.05 kHz the same code is held to the
reference's own goldens (tests/test_dio.py, tests/test_stonemask.py,
tests/test_swipe.py, where the reference fixture is present).  chip_smoke.py
holds the float32 GPU runs to the file this writes.

    JAX_PLATFORMS=cpu python tools/make_goldens_16k.py

Writes tests/golden/paths_16k.npz: dio_f0 / dio_vuv (dio -> stonemask, as
``World.encode(fs, x, f0_method="dio")`` returns them) and swipe_f0 /
swipe_vuv (``World.get_f0(fs, x, f0_method="swipe")``).
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from world_tpu import World
    from world_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    g = np.load(GOLDEN / "harvest_16k.npz")
    fs, x = int(g["fs"]), np.asarray(g["x16"], np.float64)
    w = World()
    dat = w.encode(fs, x, f0_method="dio", is_requiem=False)
    _, swipe_f0, swipe_vuv = w.get_f0(fs, x, f0_method="swipe")
    out = dict(fs=np.int64(fs),
               dio_f0=np.asarray(dat["f0"], np.float64),
               dio_vuv=np.asarray(dat["vuv"], np.float64),
               swipe_f0=np.asarray(swipe_f0, np.float64),
               swipe_vuv=np.asarray(swipe_vuv, np.float64))
    np.savez_compressed(GOLDEN / "paths_16k.npz", **out)
    for k, v in out.items():
        if v.ndim:
            print(f"{k}: {v.shape}, voiced {np.mean(v > 0):.3f}")


if __name__ == "__main__":
    main()
