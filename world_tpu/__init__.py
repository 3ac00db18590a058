"""world_tpu — a JAX (XLA + Pallas) speech vocoder framework.

A from-scratch rebuild of the WORLD vocoder with the same capabilities as
tuanad121/Python-WORLD: F0 estimation (DIO / Harvest / SWIPE'), StoneMask
refinement, CheapTrick spectral envelope, D4C / D4C-Requiem aperiodicity,
classic and Requiem synthesis, and feature codecs — as batched fixed-shape
masked compute under jit, vmap over frames/candidates, scan/matmul IIRs,
and sharded multi-utterance batches over a device mesh.
"""

__version__ = "0.1.0"

# Precision rule: every float32 dot or convolution on the main path names
# its precision at the call site, because DEFAULT may run in TF32 on the GPU
# (about three decimal digits — enough to flip Harvest's near-tied candidate
# decisions).  tests/test_precision.py enforces the rule on the traced
# programs; chip_smoke.py gates the result on the card.

from .api import World  # noqa: E402

__all__ = ["World", "__version__"]
