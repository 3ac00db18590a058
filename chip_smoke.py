"""On-card proof that the vocoder's public paths run on an NVIDIA GPU.

Run from the root of a checkout, on a machine with the card:

    python chip_smoke.py           # phases 1-7 on one card
    python chip_smoke.py --four    # only the four-card data-parallel path

Phases (one card):
  1. device: JAX's devices, versions, flags, compile cache, nvidia-smi;
  2. main path, float32: World.encode(harvest, requiem) + World.decode on
     the 4.644 s 16 kHz fixture, gated against its float64 goldens, run
     twice and required to be bitwise repeatable;
  3. batched path: batch_encode_decode, B=16 rows on a one-card mesh; every
     row equals the single-stream program's decisions and passes the gate;
  4. the Harvest refinement kernel at its real widths against a float64
     NumPy GetRefinedF0, and the 1 s Harvest stage goldens;
  5. DIO+StoneMask with classic synthesis, and SWIPE', against 16 kHz
     float64 goldens (tools/make_goldens_16k.py);
  6. long audio: seven copies of the fixture with 0.5 s gaps (~36 s);
  7. degenerate inputs: a 0.2 s clip and an all-zeros clip.

Every check prints its bar, the bar's reason and the precision it holds.
A failed check raises, so the script exits non-zero; without a GPU it exits
non-zero before any work.  The last line of standard output is one JSON
object: {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
F32 = "float32 compute; every f32 matmul/conv pinned to HIGHEST"


class CheckFailed(AssertionError):
    pass


def check(name, ok, value, bar, reason):
    print(f"  [{'ok' if ok else 'FAIL'}] {name}: {value}  "
          f"(bar {bar}; {reason})", flush=True)
    if not ok:
        raise CheckFailed(f"{name}: {value} misses bar {bar}")


def nvidia_smi():
    """The card's name and power limit, read by a child that runs no JAX."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


class Phase:
    """Prints a phase's wall time; the phase prints its compile split."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"\n== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== {self.name}: wall {time.perf_counter() - self.t0:.1f} s",
                  flush=True)


def timed_runs(fn, reps):
    """First call (compile + run) then ``reps`` steady calls; every call ends
    in block_until_ready.  Returns (first_s, [steady_s...], last_output)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return first, times, out


def report_times(tag, first, times, audio_s):
    med = statistics.median(times)
    print(f"  {tag}: first call {first:.2f} s (compile + run); steady "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms, median "
          f"{med * 1e3:.1f} ms -> {audio_s / med:.1f}x realtime "
          f"({audio_s:.3f} audio-s per call)", flush=True)
    return med


def peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use", -1)


# --------------------------------------------------------------------------
# gates
# --------------------------------------------------------------------------

def golden_gate(tag, g, f0, vuv, spectrogram, band_ap, frames=None):
    """The float64-golden bar of tests/test_api.py on one encode."""
    f0 = np.asarray(f0, np.float64)
    vuv = np.asarray(vuv) > 0.5
    gvuv = np.asarray(g["vuv"]) > 0.5
    if frames is not None:
        f0, vuv, gvuv = f0[frames], vuv[frames], gvuv[frames]
    agree = float(np.mean(vuv == gvuv))
    check(f"{tag} vuv agreement", agree > 0.99, f"{agree:.4f}", "> 0.99",
          "float32 may flip a near-tied voicing decision; f64 golden")
    both = vuv & gvuv
    gf0 = np.asarray(g["f0"], np.float64)
    gf0 = gf0 if frames is None else gf0[frames]
    rmse = float(np.sqrt(np.mean((f0[both] - gf0[both]) ** 2)))
    check(f"{tag} voiced F0 RMSE", rmse < 1.0, f"{rmse:.4f} Hz", "< 1 Hz",
          "float32 contour vs float64 golden")
    if spectrogram is None:
        return
    spec = np.asarray(spectrogram, np.float64)
    gspec = np.asarray(g["spectrogram"], np.float64)
    check(f"{tag} spectrogram shape", spec.shape == gspec.shape,
          str(spec.shape), str(gspec.shape), "static shapes")
    lsd = float(np.sqrt(np.mean((10 * np.log10(spec[:, both] + 1e-12)
                                 - 10 * np.log10(gspec[:, both] + 1e-12))
                                ** 2)))
    check(f"{tag} voiced-frame LSD", lsd < 1.0, f"{lsd:.4f} dB", "< 1 dB",
          "CheapTrick in float32 vs float64 golden")
    bap = np.asarray(band_ap, np.float64)
    gbap = np.asarray(g["band_aperiodicity"], np.float64)
    check(f"{tag} band aperiodicity shape", bap.shape == gbap.shape,
          str(bap.shape), str(gbap.shape), "static shapes")
    ap_err = float(np.max(np.abs(bap[:, both] - gbap[:, both])))
    check(f"{tag} band aperiodicity max error", ap_err < 1.0,
          f"{ap_err:.4f} dB", "< 1.0", "D4C-Requiem in float32 vs float64")


def waveform_gate(tag, y, x):
    y = np.asarray(y, np.float64)
    check(f"{tag} waveform finite", bool(np.all(np.isfinite(y))),
          f"{y.size} samples", "all finite", "no NaN/inf may reach the output")
    ratio = float(np.sqrt(np.mean(y ** 2)) / np.sqrt(np.mean(x ** 2)))
    check(f"{tag} waveform RMS / input RMS", 0.2 < ratio < 5.0,
          f"{ratio:.3f}", "in (0.2, 5)", "resynthesis keeps the level")


def batched_row_gate(tag, row, single, rel_l2_bar):
    """A batched row against the single-stream program on the same input
    (tests/test_batched_bitwise.py, __graft_entry__.py)."""
    vuv_b, vuv_s = np.asarray(row["vuv"]), np.asarray(single["vuv"])
    check(f"{tag} vuv == single-stream", bool(np.array_equal(vuv_b, vuv_s)),
          f"{int(np.sum(vuv_b != vuv_s))} differing frames", "bitwise",
          "decisions must not depend on the batch")
    f0_b = np.asarray(row["f0"], np.float64)
    f0_s = np.asarray(single["f0"], np.float64)
    check(f"{tag} voicing == single-stream",
          bool(np.array_equal(f0_b > 0, f0_s > 0)),
          f"{int(np.sum((f0_b > 0) != (f0_s > 0)))} flips", "none",
          "decisions must not depend on the batch")
    drift = float(np.max(np.abs(f0_b - f0_s)))
    check(f"{tag} f0 drift", drift < 1e-3, f"{drift:.2e} Hz", "< 1e-3 Hz",
          "last-ulp value noise only")
    y_b, y_s = (np.asarray(row["y"], np.float64),
                np.asarray(single["y"], np.float64))
    rel = float(np.linalg.norm(y_b - y_s) / max(np.linalg.norm(y_s), 1e-30))
    check(f"{tag} waveform rel-L2 vs single-stream", rel < rel_l2_bar,
          f"{rel:.2e}", f"< {rel_l2_bar:g}",
          "a 1-ulp f0 change may move a pulse by one sample")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device(n_expected):
    import jax
    import jaxlib

    from world_tpu.utils.cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    d0 = devs[0]
    print(f"devices: {devs}")
    print(f"platform {d0.platform}, device_kind {d0.device_kind!r}, "
          f"count {len(devs)}")
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
          f"python {sys.version.split()[0]}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {cache}")
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    if d0.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {d0.platform!r}); "
              f"nothing was run", file=sys.stderr)
        sys.exit(2)
    if len(devs) < n_expected:
        print(f"chip_smoke: needs {n_expected} GPUs, found {len(devs)}",
              file=sys.stderr)
        sys.exit(2)
    return devs


def load_fixture():
    g = np.load(GOLDEN / "harvest_16k.npz")
    return g, int(g["fs"]), np.asarray(g["x16"], np.float32)


@lru_cache(maxsize=None)
def _single_stream_fn(fs, n_samples):
    import jax

    from world_tpu.parallel.batch import _encode_decode_one, default_caps

    max_pulses, max_candidates, max_sections = default_caps(n_samples, fs)
    return jax.jit(lambda x, p, n: _encode_decode_one(
        x, p, n, fs=fs, frame_period=5, max_pulses=max_pulses,
        max_candidates=max_candidates, max_sections=max_sections))


def single_stream(fs, x):
    """The unbatched encode+decode program (parallel.batch's per-row
    function under plain jit) on one utterance: the reference every batched
    row is held to.  World.decode is not that reference: it sums the pulse
    phase in a separately compiled program, and a float32 cumsum over
    ~74k samples places some pulses a sample apart."""
    import jax
    import jax.numpy as jnp

    from world_tpu.synth.seeds import get_seeds_signals

    seeds = get_seeds_signals(fs)
    return jax.block_until_ready(_single_stream_fn(fs, len(x))(
        jnp.asarray(x), jnp.asarray(np.asarray(seeds["pulse"], np.float32)),
        jnp.asarray(np.asarray(seeds["noise"], np.float32))))


@lru_cache(maxsize=None)
def downsampler(fs):
    """Harvest's decimation to ~8 kHz as one jitted program."""
    import jax

    from world_tpu.f0.harvest import downsample

    return jax.jit(lambda x: downsample(x, fs, 8000)[0])


def long_audio(fs, x16):
    """Seven copies of the fixture with ~0.5 s of silence between them; the
    gap is padded to whole 5 ms frames so copy k's frames line up with the
    golden's.  Returns (signal, frames per period)."""
    hop = int(fs * 0.005)
    gap = int(0.5 * fs) + (-(len(x16) + int(0.5 * fs))) % hop
    one = np.concatenate([x16, np.zeros(gap, np.float32)])
    return np.concatenate([one] * 6 + [x16]), len(one) // hop


def warm_up(tasks):
    """Run each task's first call (its compilations) concurrently: XLA
    compiles release the GIL, so a cold start pays roughly the longest
    compile rather than the sum.  A failed task raises here."""
    import jax

    def timed(fn):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(tasks)) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in tasks.items()}
        for name, fut in futures.items():
            print(f"  {name}: {fut.result():.1f} s (compile + first run, "
                  f"concurrent)", flush=True)
    print(f"  all programs compiled in {time.perf_counter() - t0:.1f} s of "
          f"wall time", flush=True)


def phase_main_path(g, fs, x16, w):
    dur = len(x16) / fs

    def run():
        dat = w.encode(fs, x16, f0_method="harvest", is_requiem=True)
        out = w.decode(dict(dat))
        return dat, out["out"]

    first, times, _ = timed_runs(lambda: run(), 0)
    (dat1, y1), (dat2, y2) = run(), run()
    for k in ("f0", "vuv", "spectrogram", "aperiodicity"):
        same = bool(np.array_equal(np.asarray(dat1[k]), np.asarray(dat2[k])))
        check(f"repeat run: {k} bitwise equal", same, same, "True",
              "no atomics or autotuning nondeterminism on the main path")
    check("repeat run: waveform bitwise equal", bool(np.array_equal(y1, y2)),
          bool(np.array_equal(y1, y2)), "True", "deterministic synthesis")
    golden_gate("main path", g, dat1["f0"], dat1["vuv"], dat1["spectrogram"],
                dat1["aperiodicity"])
    waveform_gate("main path", y1, x16)
    _, times, _ = timed_runs(lambda: run(), 5)
    report_times("World.encode+decode (harvest, requiem)", first, times, dur)


def phase_batched(g, fs, x16, dev, B=16):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from world_tpu.parallel.batch import (batch_encode_decode, batch_fn,
                                          default_caps, make_mesh)
    from world_tpu.synth.seeds import get_seeds_signals

    mesh = make_mesh([dev])
    xs = np.stack([x16] * B)
    dur = len(x16) / fs
    first, times, out = timed_runs(
        lambda: batch_encode_decode(xs, fs, mesh=mesh), 3)
    med = report_times(f"batch_encode_decode B={B}, one-card mesh", first,
                       times, dur * B)
    print(f"  peak_bytes_in_use after the batched runs: "
          f"{peak_bytes(dev) / 2**30:.2f} GiB", flush=True)
    seeds = get_seeds_signals(fs)
    pulse = jnp.asarray(np.asarray(seeds["pulse"], np.float32))
    noise = jnp.asarray(np.asarray(seeds["noise"], np.float32))
    xs_sh = jax.device_put(jnp.asarray(xs), NamedSharding(mesh, P("data")))
    t0 = time.perf_counter()
    compiled = batch_fn(fs, 5, *default_caps(xs.shape[1], fs), mesh).lower(
        xs_sh, pulse, noise).compile()
    print(f"  batched step lower+compile (cache-backed) "
          f"{time.perf_counter() - t0:.1f} s; memory_analysis: "
          f"{compiled.memory_analysis()}", flush=True)
    single = single_stream(fs, x16)
    for i in range(B):
        row = {k: out[k][i] for k in ("f0", "vuv", "y", "spectrogram",
                                      "band_aperiodicity")}
        batched_row_gate(f"row {i}", row, single, 3e-2)
        golden_gate(f"row {i}", g, row["f0"], row["vuv"],
                    np.asarray(row["spectrogram"]).T,
                    np.asarray(row["band_aperiodicity"]).T)
    overflow = np.asarray(out["_overflow"])
    check("batched static tables", not overflow.any(), overflow.tolist(),
          "no overflow", "capacity flags of every row")
    return med


def run_gpu_tests(dev):
    """Call every test marked ``gpu`` in tests/ with this card (they skip on
    the CPU; pytest's conftest pins the CPU, so they are called directly)."""
    import importlib.util

    n = 0
    for path in sorted((ROOT / "tests").glob("test_*.py")):
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for name in sorted(dir(mod)):
            fn = getattr(mod, name)
            marks = [m.name for m in getattr(fn, "pytestmark", [])]
            if name.startswith("test_") and "gpu" in marks:
                t0 = time.perf_counter()
                fn(gpu=dev)
                n += 1
                print(f"  [ok] {path.name}::{name} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check("gpu-marked tests run", n > 0, n, ">= 1", "the tests that skip on "
          "the CPU run here")


def phase_refinement(dev):
    import jax
    import jax.numpy as jnp

    from world_tpu.f0.harvest import harvest
    from world_tpu.ops.refine_dft import get_refined_f0_np, refine_impl

    impl = refine_impl(dev.platform, jnp.float32)
    run_gpu_tests(dev)
    f0_floor, f0_ceil = 71.0, 800.0
    # the 1 s Harvest fixture at 16 kHz: the real refinement widths, its real
    # candidate grid, and stage goldens from the float64 reference
    gs = np.load(GOLDEN / "harvest_small.npz")
    fs, x = int(gs["fs"]), np.asarray(gs["x"], np.float32)
    t0 = time.perf_counter()
    hs = {k: np.asarray(v) for k, v in harvest(
        x, fs, max_candidates=8, max_sections=64, debug_outputs=True).items()}
    y = np.asarray(downsampler(fs)(x), np.float64)
    afs = fs / 2
    print(f"  harvest with stage outputs: {time.perf_counter() - t0:.1f} s "
          f"(compile + run)", flush=True)
    cands = np.asarray(hs["_cands_overlap"], np.float64)
    ref = np.asarray(hs["_cands_refined"], np.float64)
    score = np.asarray(hs["_scores_refined"], np.float64)
    max_half = int(np.ceil(3 * afs / f0_floor / 2))
    S = int(2 ** np.ceil(np.log2(2 * max_half + 1) + 1))
    print(f"  implementation {impl!r}; actual_fs {afs:g}, W={2 * max_half + 1},"
          f" nb={S // 2 + 1}, candidate grid {cands.shape[0]} x "
          f"{cands.shape[1]} frames (compacted to <= 48 slots per frame)")
    rows = np.argwhere(cands > 0)
    rng = np.random.RandomState(0)
    pick = rows[rng.choice(len(rows), min(2000, len(rows)), replace=False)]
    check("sampled refinement rows", len(pick) >= 2000, len(pick), ">= 2000",
          "enough rows to see a 0.1% flip rate")
    tp = np.arange(cands.shape[1]) / 1000.0
    d_f0, d_sc, hard, border = [], [], 0, 0
    for c, q in pick:
        f0c = float(np.float32(cands[c, q]))
        raw_f0, raw_sc = get_refined_f0_np(y, afs, tp[q], f0c, f0_floor,
                                           f0_ceil, gate=False)
        want = get_refined_f0_np(y, afs, tp[q], f0c, f0_floor, f0_ceil)
        got = (ref[c, q], score[c, q])
        if (want[0] != 0) != (got[0] != 0):
            near = (abs(raw_sc - 2.5) < 0.025 or abs(raw_f0 - f0_floor) < 0.01
                    or abs(raw_f0 - f0_ceil) < 0.01)
            border += near
            hard += not near
            continue
        if want[0] != 0:
            d_f0.append(abs(got[0] - want[0]))
            d_sc.append(abs(got[1] - want[1]) / want[1])
    d_f0, d_sc = np.asarray(d_f0), np.asarray(d_sc)
    print(f"  {len(pick)} sampled (candidate, frame) rows, {len(d_f0)} "
          f"accepted by both", flush=True)
    check("refinement decisions vs f64 GetRefinedF0", hard == 0,
          f"{hard} non-borderline flips, {border} borderline", "0 flips "
          "unless |score-2.5|<1% or f0 within 0.01 Hz of a bound",
          "float32 windowed sums (~1e-7 rel) vs float64 reference")
    check("refinement borderline flips", border <= 5, border, "<= 5 of 2000",
          "threshold ties only")
    check("refined f0 abs error", float(d_f0.max()) < 0.01,
          f"max {d_f0.max():.2e} Hz, p99 {np.percentile(d_f0, 99):.2e} Hz",
          "< 0.01 Hz", "float32 evaluation; CPU float32 twin measures 1.4e-4")
    check("refined score rel error", float(d_sc.max()) < 1e-3,
          f"max {d_sc.max():.2e}, p99 {np.percentile(d_sc, 99):.2e}", "< 1e-3",
          "score = 1/variation amplifies float32 noise on good candidates; "
          "CPU float32 twin measures 5.4e-5")

    check("1 s fixture static tables",
          not (bool(hs["_refine_overflow"]) or bool(hs["_section_overflow"])),
          "no overflow", "no overflow", "capacity flags")
    refd = gs["f0_candidates_refined"]
    mc_ref, mc = refd.shape[0] // 7, hs["_cands_refined"].shape[0] // 7
    worst = min(np.isclose(hs["_cands_refined"][i * mc:i * mc + mc_ref],
                           refd[i * mc_ref:(i + 1) * mc_ref], rtol=1e-5,
                           atol=1e-3).mean() for i in range(7))
    check("1 s fixture refined candidates (worst block)", worst > 0.995,
          f"{worst:.4f}", "> 0.995 within rtol 1e-5, atol 1e-3 Hz",
          "tests/test_harvest_small.py bar; f32 error ~1e-4 Hz")
    for stage, key in (("_f0_base", "f0_base"), ("_f0_step2", "f0_step2"),
                       ("_f0_step4", "f0_step4")):
        agree = float(np.isclose(hs[stage], gs[key], rtol=1e-5,
                                 atol=1e-3).mean())
        check(f"1 s fixture {key}", agree > 0.99, f"{agree:.4f}", "> 0.99",
              "tests/test_harvest_small.py bar")
    vuv, gvuv = hs["vuv"] > 0, np.asarray(gs["vuv"]) > 0
    agree = float(np.mean(vuv == gvuv))
    both = vuv & gvuv
    rmse = float(np.sqrt(np.mean((hs["f0"][both] - gs["f0"][both]) ** 2)))
    check("1 s fixture vuv agreement", agree > 0.99, f"{agree:.4f}", "> 0.99",
          "tests/test_harvest_small.py bar")
    check("1 s fixture voiced F0 RMSE", rmse < 0.1, f"{rmse:.4f} Hz",
          "< 0.1 Hz", "tests/test_harvest_small.py bar")


def phase_other_paths(fs, x16, w):
    gp = np.load(GOLDEN / "paths_16k.npz")
    t0 = time.perf_counter()
    dat = w.encode(fs, x16, f0_method="dio", is_requiem=False)
    y = w.decode(dict(dat))["out"]
    print(f"  dio+stonemask encode + classic decode: "
          f"{time.perf_counter() - t0:.1f} s (compile + run)", flush=True)
    f0, gf0 = np.asarray(dat["f0"], np.float64), gp["dio_f0"]
    v, gv = f0 > 0, gf0 > 0
    agree = float(np.mean(v == gv))
    dd = np.abs(f0[v & gv] - gf0[v & gv])
    med = float(np.median(dd))
    trim = float(np.sqrt(np.mean(np.sort(dd)[: max(1, int(0.99 * dd.size))]
                                 ** 2)))
    check("dio vuv agreement", agree > 0.98, f"{agree:.4f}", "> 0.98",
          "DIO bar; float32 vs float64 golden")
    check("dio voiced F0 median error", med < 0.01, f"{med:.5f} Hz",
          "< 0.01 Hz", "DIO bar: the bulk of frames must be clean")
    check("dio voiced F0 trimmed-99% RMSE", trim < 1.0,
          f"{trim:.4f} Hz (full {np.sqrt(np.mean(dd ** 2)):.4f})", "< 1 Hz",
          "StoneMask's 20% keep threshold makes a ~1% tail chaotic in f32")
    waveform_gate("classic", y, x16)

    t0 = time.perf_counter()
    _, f0s, _ = w.get_f0(fs, x16, f0_method="swipe")
    print(f"  swipe: {time.perf_counter() - t0:.1f} s (compile + run)",
          flush=True)
    f0s, gs = np.asarray(f0s, np.float64), gp["swipe_f0"]
    check("swipe finite", bool(np.all(np.isfinite(f0s))), "", "all finite",
          "no NaN may leak from the pitch-strength interpolation")
    v, gv = f0s > 0, gs > 0
    agree = float(np.mean(v == gv))
    rel = np.abs(f0s[v & gv] - gs[v & gv]) / gs[v & gv]
    check("swipe vuv agreement", agree > 0.97, f"{agree:.4f}", "> 0.97",
          "SWIPE' bar of tests/test_swipe.py; f32 vs f64 golden")
    check("swipe median relative error", float(np.median(rel)) < 1e-4,
          f"{np.median(rel):.2e}", "< 1e-4", "SWIPE' bar of tests/test_swipe.py")
    within = float(np.mean(rel < 0.01))
    check("swipe frames within 1%", within > 0.97, f"{within:.4f}", "> 0.97",
          "SWIPE' bar of tests/test_swipe.py")


def phase_long_audio(g, fs, x16, w, dev):
    xl, period_frames = long_audio(fs, x16)
    print(f"  input: 7 copies, {period_frames} frames apart, {len(xl)} "
          f"samples ({len(xl) / fs:.2f} s)", flush=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        dat = w.encode(fs, xl, f0_method="harvest", is_requiem=True)
        y = w.decode(dict(dat))["out"]
        print(f"  encode + decode: {time.perf_counter() - t0:.1f} s "
              f"(compile + run)", flush=True)
    cap = [str(c.message) for c in caught
           if issubclass(c.category, RuntimeWarning)]
    check("long audio capacity warnings", not cap, cap or "none", "none",
          "static tables sized for the input length")
    for k in ("f0", "spectrogram", "aperiodicity"):
        check(f"long audio {k} finite",
              bool(np.all(np.isfinite(np.asarray(dat[k])))), "", "all finite",
              "no NaN/inf")
    check("long audio waveform finite", bool(np.all(np.isfinite(y))),
          f"{y.size} samples", "all finite", "no NaN/inf")
    n_g = len(np.asarray(g["vuv"]))
    interior = np.arange(20, n_g - 20)          # 100 ms in from each edge
    vuv = np.asarray(dat["vuv"]) > 0.5
    gvuv = np.asarray(g["vuv"]) > 0.5
    for k in range(7):
        off = k * period_frames
        agree = float(np.mean(vuv[off + interior] == gvuv[interior]))
        check(f"long audio copy {k} interior vuv agreement", agree > 0.99,
              f"{agree:.4f}", "> 0.99", "each copy is the golden fixture")
    print(f"  peak_bytes_in_use so far: {peak_bytes(dev) / 2**30:.2f} GiB",
          flush=True)


def phase_degenerate(fs, x16, w):
    short = x16[: int(0.2 * fs)]
    dat = w.encode(fs, short, f0_method="harvest", is_requiem=True)
    y = w.decode(dict(dat))["out"]
    check("0.2 s clip outputs finite",
          all(bool(np.all(np.isfinite(np.asarray(v))))
              for v in (dat["f0"], dat["spectrogram"], dat["aperiodicity"], y)),
          f"{len(short)} samples in, {len(y)} out", "all finite",
          "static caps must hold at tiny lengths")
    zeros = np.zeros_like(x16)                  # reuses the main-path program
    dat = w.encode(fs, zeros, f0_method="harvest", is_requiem=True)
    voiced = float(np.mean(np.asarray(dat["vuv"])))
    check("all-zeros clip unvoiced", voiced == 0.0, f"voiced {voiced}",
          "0.0", "silence has no pitch")
    check("all-zeros f0 finite", bool(np.all(np.isfinite(dat["f0"]))), "",
          "all finite", "no NaN/inf")


def phase_four(g, fs, x16, devs, B=16):
    import jax
    import jax.numpy as jnp

    from world_tpu.parallel.batch import (batch_encode_decode,
                                          frame_sharded_cheaptrick, make_mesh)
    from world_tpu.spectral.cheaptrick import _cheaptrick_core, default_fft_size

    mesh = make_mesh(devs[:4])
    xs = np.stack([x16] * B)
    dur = len(x16) / fs
    first, times, out = timed_runs(
        lambda: batch_encode_decode(xs, fs, mesh=mesh), 3)
    report_times(f"batch_encode_decode B={B} over 4 cards (4 rows each)",
                 first, times, dur * B)
    for d in devs[:4]:
        print(f"  {d}: peak_bytes_in_use {peak_bytes(d) / 2**30:.2f} GiB")
    single = single_stream(fs, x16)                # on card 0
    for i in range(B):
        row = {k: out[k][i] for k in ("f0", "vuv", "y", "spectrogram",
                                      "band_aperiodicity")}
        batched_row_gate(f"row {i} (card {i * 4 // B})", row, single, 1e-2)
        golden_gate(f"row {i}", g, row["f0"], row["vuv"],
                    np.asarray(row["spectrogram"]).T,
                    np.asarray(row["band_aperiodicity"]).T)

    f0 = jnp.asarray(single["f0"])
    vuv = jnp.asarray(single["vuv"])
    tp = jnp.asarray(np.arange(f0.shape[0]) * 0.005, jnp.float32)
    t0 = time.perf_counter()
    env, total = frame_sharded_cheaptrick(jnp.asarray(x16), f0, vuv, tp, fs,
                                          mesh)
    env = np.asarray(env, np.float64)
    print(f"  frame-sharded CheapTrick over 4 cards: "
          f"{time.perf_counter() - t0:.1f} s (compile + run), psum energy "
          f"{float(total):.3f}", flush=True)
    f0_ct = jnp.where(vuv == 0, 500.0, f0)
    ref = np.asarray(jax.jit(lambda a, b, c: _cheaptrick_core(
        a, fs, b, c, default_fft_size(fs), -0.15)[0])(
            jnp.asarray(x16), f0_ct, tp), np.float64)
    floor = ref.max(axis=1, keepdims=True) * 1e-3
    ddb = float(np.abs(10 * np.log10(np.maximum(env, floor))
                       - 10 * np.log10(np.maximum(ref, floor))).max())
    check("frame-sharded CheapTrick vs unsharded", ddb < 0.2, f"{ddb:.4f} dB",
          "< 0.2 dB (floor -30 dB of each frame's peak)",
          "same frames, other compilation; f32 cumsum-difference noise "
          "below -30 dB is not a property of the formulation")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card data-parallel path")
    args = ap.parse_args()
    t_start = time.perf_counter()

    with Phase("phase 1: device"):
        devs = phase_device(4 if args.four else 1)
    import jax

    from world_tpu import World

    g, fs, x16 = load_fixture()
    print(f"fixture: {len(x16)} samples at {fs} Hz ({len(x16) / fs:.3f} s); "
          f"{F32}")
    from world_tpu.f0.harvest import harvest
    from world_tpu.parallel.batch import batch_encode_decode, make_mesh

    xs16 = np.stack([x16] * 16)
    if args.four:
        mesh4 = make_mesh(devs[:4])
        with Phase("compile: the four-card programs, concurrently"):
            warm_up({
                "batched B=16 over 4 cards":
                    lambda: batch_encode_decode(xs16, fs, mesh=mesh4)["y"],
                "single-stream program (card 0)":
                    lambda: single_stream(fs, x16)["y"],
            })
        with Phase("four cards: data parallelism + frame-sharded CheapTrick"):
            phase_four(g, fs, x16, devs)
    else:
        dev = devs[0]
        w = World()
        gs = np.load(GOLDEN / "harvest_small.npz")
        fs_small, x_small = int(gs["fs"]), np.asarray(gs["x"], np.float32)
        mesh1 = make_mesh([dev])

        def requiem(x):
            return lambda: w.decode(dict(w.encode(
                fs, x, f0_method="harvest", is_requiem=True)))["out"]

        with Phase("compile: every program of phases 2-7, concurrently"):
            warm_up({
                "main path (World, 4.6 s)": requiem(x16),
                "batched B=16, one-card mesh":
                    lambda: batch_encode_decode(xs16, fs, mesh=mesh1)["y"],
                "single-stream program": lambda: single_stream(fs, x16)["y"],
                "Harvest stage outputs (1 s)": lambda: (
                    harvest(x_small, fs_small, max_candidates=8,
                            max_sections=64, debug_outputs=True)["f0"],
                    downsampler(fs_small)(x_small)),
                "DIO+StoneMask + classic synthesis": lambda: w.decode(dict(
                    w.encode(fs, x16, f0_method="dio",
                             is_requiem=False)))["out"],
                "SWIPE'": lambda: w.get_f0(fs, x16, f0_method="swipe")[1],
                "long audio": requiem(long_audio(fs, x16)[0]),
                "0.2 s clip": requiem(x16[: int(0.2 * fs)]),
            })
        with Phase("phase 2: main path, single stream"):
            phase_main_path(g, fs, x16, w)
        with Phase("phase 3: batched path"):
            phase_batched(g, fs, x16, dev)
        with Phase("phase 4: refinement at real widths"):
            phase_refinement(dev)
        with Phase("phase 5: DIO+StoneMask classic and SWIPE'"):
            phase_other_paths(fs, x16, w)
        with Phase("phase 6: long audio"):
            phase_long_audio(g, fs, x16, w, dev)
        with Phase("phase 7: degenerate inputs"):
            phase_degenerate(fs, x16, w)
    print(f"\nall phases passed in {time.perf_counter() - t_start:.1f} s; "
          f"nvidia-smi: {nvidia_smi()}", flush=True)
    d0 = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
