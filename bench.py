"""Benchmark: harvest + requiem encode/decode xRT on the 16 kHz fixture.

Prints the device and the card (name, power limit) on earlier lines and ONE
JSON line last {"metric", "value", "unit", "vs_baseline", ...}.  Exits
non-zero without a GPU.  Baseline (BASELINE.md): the NumPy reference runs
harvest encode in 27.2 s + requiem-style decode ~0.65 s on a 4.644 s clip
=> 0.1667x realtime.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def main():
    import jax
    import jax.numpy as jnp

    from world_tpu.parallel.batch import _encode_decode_one, default_caps
    from world_tpu.synth.seeds import get_seeds_signals
    from world_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        card = f"nvidia-smi unavailable ({e})"
    print(f"device: platform {dev.platform}, kind {dev.device_kind!r}, "
          f"count {len(jax.devices())}; card: {card}", flush=True)
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU (JAX platform {dev.platform!r})")

    g = np.load(ROOT / "tests" / "golden" / "harvest_16k.npz")
    fs = int(g["fs"])
    x = np.asarray(g["x16"], np.float32)
    audio_seconds = len(x) / fs
    seeds = get_seeds_signals(fs)
    pulse = jnp.asarray(np.asarray(seeds["pulse"], dtype=np.float32))
    noise = jnp.asarray(np.asarray(seeds["noise"], dtype=np.float32))
    max_pulses, max_candidates, max_sections = default_caps(len(x), fs)

    def one(xi):
        return _encode_decode_one(xi, pulse, noise, fs=fs, frame_period=5,
                                  max_pulses=max_pulses,
                                  max_candidates=max_candidates,
                                  max_sections=max_sections)

    def golden_gate(f0_arr, tag):
        """A reported number must come from a run that meets the float64
        golden bar (vuv agreement > 99%, voiced F0 RMSE < 1 Hz)."""
        f0_p = np.asarray(f0_arr, np.float64)
        vuv_p = f0_p > 0
        vuv_g = g["vuv"] > 0.5
        agree = float(np.mean(vuv_p == vuv_g))
        both = vuv_p & vuv_g
        rmse = float(np.sqrt(np.mean((f0_p[both] - g["f0"][both]) ** 2)))
        print(f"bench: {tag} gate: vuv agree {agree:.4f}, f0 rmse "
              f"{rmse:.4f} Hz", flush=True)
        return agree > 0.99 and rmse < 1.0

    def measure(fn, arg, per_call_utts, reps=5):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(arg))
        compile_s = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(arg))
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        return out, {"compile_plus_first_s": compile_s,
                     "rep_ms": [t * 1e3 for t in times],
                     "median_ms": med * 1e3,
                     "xrt": audio_seconds * per_call_utts / med}

    paths = {}
    out, single = measure(jax.jit(one), jnp.asarray(x), 1)
    single["gated"] = golden_gate(out["f0"], "single-stream")
    paths["single"] = single
    B = 4
    out_b, batched = measure(jax.jit(jax.vmap(one)),
                             jnp.asarray(np.stack([x] * B)), B)
    batched["gated"] = golden_gate(out_b["f0"][0], f"batch-{B}")
    paths[f"batch{B}"] = batched
    xrt = max((p["xrt"] for p in paths.values() if p["gated"]), default=0.0)

    baseline_xrt = 4.644 / (27.2 + 0.65)  # measured reference (BASELINE.md)
    print(json.dumps({
        "metric": "harvest+requiem encode+decode per-card throughput xRT "
                  "(audio-s/s; median of 5 reps, best gated path of "
                  "single-stream / 4-batch)",
        "value": xrt,
        "unit": "x realtime",
        "vs_baseline": xrt / baseline_xrt,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "paths": paths,
    }))


if __name__ == "__main__":
    main()
