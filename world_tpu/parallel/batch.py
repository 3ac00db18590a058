"""Multi-utterance / multi-device execution: DP over utterances, SP over
frames.

The reference's only parallelism is a fork-based mp.Pool inside harvest
(/root/reference/world/harvest.py:140-142).  Here:

  * data parallelism: a batch of equal-length utterances is sharded over the
    mesh 'data' axis; the whole encode(+decode) pipeline runs as ONE
    shard_map'd program per shard — no communication needed;
  * sequence parallelism: the frame axis of CheapTrick (frames are
    independent) is sharded via shard_map, with a psum across the shards;
  * everything works on any 1-D jax.sharding.Mesh — one GPU, four GPUs of a
    host, or N virtual CPU devices.
"""
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..aperiodicity.common import d4c_fft_size
from ..aperiodicity.d4c_requiem import _d4c_requiem_core
from ..aperiodicity.d4c import _d4c_core
from ..spectral.cheaptrick import _cheaptrick_core, default_fft_size
from ..f0.dio import _dio_core
from ..f0.harvest import _harvest_core
from ..f0.stonemask import _stonemask_core
from ..synth.classic import _synthesis_core
from ..synth.requiem import _excitation_core, _waveform_core


def make_mesh(devices=None, axis="data"):
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def _encode_decode_one(x, pulse_seed, noise_seed, fs: int, frame_period: int,
                       max_pulses: int, max_candidates: int, max_sections: int):
    """Full harvest->cheaptrick->d4cRequiem->synthesisRequiem pipeline for one
    utterance; pure function of the signal, jit/vmap/pjit-friendly."""
    sig_len = x.shape[0]
    hv = _harvest_core(x, fs, 71.0, 800.0, float(frame_period), max_candidates,
                       max_sections, sig_len)
    f0, vuv, tp = hv["f0"], hv["vuv"], hv["temporal_positions"]
    fft_size = default_fft_size(fs)
    f0_ct = jnp.where(vuv == 0, 500.0, f0)
    fp_ms = float(frame_period)
    env, _, f0_eff = _cheaptrick_core(x, fs, f0_ct, tp, fft_size, -0.15, fp_ms)
    f0_d4c = jnp.where(vuv == 0, 0.0, f0_eff)
    fft_req = int(2 ** np.ceil(np.log2(3 * fs / 47 + 1)))
    n_ap = int(np.floor(min(15000, fs / 2 - 3000) / 3000))
    band_ap = _d4c_requiem_core(x, fs, f0_d4c, tp, fft_req, 0.85, 3000.0, n_ap,
                                fp_ms)

    y_length = int(np.floor((int(1000 * sig_len / fs / frame_period + 1) - 1)
                            * frame_period / 1000 * fs)) + 1
    noise_offsets = jnp.zeros(pulse_seed.shape[1], jnp.int32)
    excitation, pulse_overflow = _excitation_core(
        tp, f0_d4c, vuv, band_ap.T, pulse_seed, noise_seed, noise_offsets,
        fs, y_length, max_pulses, 40, float(frame_period) / 1000.0)
    fps = int(frame_period / 1000 * fs)
    y = _waveform_core(excitation, env.T, tp, fs, fft_size, fps)
    return {"f0": f0_d4c, "vuv": vuv, "spectrogram": env,
            "band_aperiodicity": band_ap, "y": y,
            "_overflow": (hv["_refine_overflow"] | hv["_section_overflow"]
                          | pulse_overflow)}


def _encode_classic_one(x, fs: int, frame_period: int):
    """dio -> stonemask -> cheaptrick -> d4c for one utterance (the
    reference's BASELINE config-1 path, main.py:126-130 + 138-146); pure
    function of the signal, jit/vmap/pjit-friendly."""
    sig_len = x.shape[0]
    src = _dio_core(x, fs, 71.0, 800.0, 2, 4000, float(frame_period), 0.1,
                    sig_len)
    vuv, tp = src["vuv"], src["temporal_positions"]
    max_half = int(np.ceil(3 * fs / 71.0 / 2))
    refined = _stonemask_core(x, fs, tp, src["f0"], max_half)
    f0 = jnp.where(src["f0"] != 0, refined, src["f0"])

    fft_size = default_fft_size(fs)
    fp_ms = float(frame_period)
    f0_ct = jnp.where(vuv == 0, 500.0, f0)
    env, _, f0_eff = _cheaptrick_core(x, fs, f0_ct, tp, fft_size, -0.15, fp_ms)
    f0_d4c = jnp.where(vuv == 0, 0.0, f0_eff)
    freq_interval = 2000.0 if fs < 16000 else 3000.0
    n_ap = int(np.floor(min(15000, fs / 2 - freq_interval) / freq_interval))
    ap, _, _ = _d4c_core(x, fs, f0_d4c, tp, d4c_fft_size(fs), fft_size,
                         0.85, freq_interval, n_ap, fp_ms)
    return {"f0": f0_d4c, "vuv": vuv, "temporal_positions": tp,
            "spectrogram": env.T, "aperiodicity": ap.T}


def _encode_decode_classic_one(x, key, fs: int, frame_period: int):
    """Full classic round-trip (dio+stonemask encode -> classic pulse/noise
    synthesis, synthesis.py:21-82) as one jittable program.  Static caps are
    derived from the f0 ceiling (800 Hz) rather than the data so the whole
    pipeline stays shape-static under jit/vmap."""
    dat = _encode_classic_one(x, fs, frame_period)
    sig_len = x.shape[0]
    n_frames = int(1000 * sig_len / fs / frame_period + 1)
    tp_last = (n_frames - 1) * frame_period / 1000.0
    y_length = len(np.arange(0.0, tp_last + 1.0 / fs, 1.0 / fs))
    fft_size = default_fft_size(fs)
    f0_hi = 800.0 * 1.2  # static bound: dio clips candidates at f0_ceil
    max_pulses = int(2 ** np.ceil(np.log2(np.ceil(tp_last * max(500.0, f0_hi))
                                          + 8)))
    max_noise = int(fs / 40) + 4
    k_overlap = min(int(np.ceil(fft_size * 840.0 / fs / 8) + 1) * 8,
                    max_pulses)
    y, _overflow = _synthesis_core(
        dat["f0"], dat["vuv"], dat["temporal_positions"], dat["spectrogram"],
        dat["aperiodicity"], key, fs, y_length, fft_size, max_pulses,
        max_noise, "gaussian", "standard", k_overlap,
        float(frame_period) / 1000.0)
    return dict(dat, y=y, _overflow=_overflow)


def default_caps(n_samples: int, fs: int):
    """(max_pulses, max_candidates, max_sections): the static table sizes
    :func:`batch_encode_decode` uses for utterances of ``n_samples``."""
    from ..f0.harvest import default_max_sections

    max_pulses = int(2 ** np.ceil(np.log2(n_samples / fs * 1000 + 8)))
    n_bands = int(np.ceil(np.log2((800 * 1.1) / (71 * 0.9)) * 40))
    max_candidates = int(n_bands / 10 + 0.5)
    return max_pulses, max_candidates, default_max_sections(n_samples, fs)


def batch_encode_decode(xs, fs: int, mesh: Mesh = None, frame_period: int = 5,
                        seed: int = 0, max_pulses: int = None,
                        max_candidates: int = None, max_sections: int = None,
                        check_capacity: bool = True):
    """Shard a (batch, n_samples) utterance batch over the mesh and run the
    full encode+decode pipeline data-parallel.

    Static table caps default to the same adaptive sizes the single-utterance
    API uses (notably ``default_max_sections`` — a fixed 256 saturates past
    ~11 s and silently zeroes later voicing).  ``check_capacity`` syncs the
    per-utterance overflow flags once after the batch and raises the same
    RuntimeWarning as the public ``harvest()``/``decode()`` paths.
    """
    from ..synth.seeds import get_seeds_signals

    xs = jnp.asarray(xs)
    seeds = get_seeds_signals(int(fs), seed=seed)
    pulse_seed = jnp.asarray(seeds["pulse"], xs.dtype)
    noise_seed = jnp.asarray(seeds["noise"], xs.dtype)
    d_pulses, d_candidates, d_sections = default_caps(xs.shape[1], fs)
    max_pulses = d_pulses if max_pulses is None else max_pulses
    max_candidates = d_candidates if max_candidates is None else max_candidates
    max_sections = d_sections if max_sections is None else max_sections

    fn = batch_fn(int(fs), int(frame_period), int(max_pulses),
                  int(max_candidates), int(max_sections), mesh)
    if mesh is not None:
        xs = jax.device_put(xs, NamedSharding(mesh, P("data", None)))
    out = fn(xs, pulse_seed, noise_seed)
    if check_capacity:
        _warn_batch_capacity(np.asarray(out["_overflow"]), max_sections,
                             max_pulses)
    return out


@lru_cache(maxsize=None)
def batch_fn(fs: int, frame_period: int, max_pulses: int, max_candidates: int,
             max_sections: int, mesh: Mesh = None):
    """The jitted batched program ``(xs, pulse_seed, noise_seed) -> out`` of
    :func:`batch_encode_decode`, built once per configuration so repeated
    calls reuse one compilation."""
    fn = jax.vmap(partial(_encode_decode_one, fs=fs, frame_period=frame_period,
                          max_pulses=max_pulses,
                          max_candidates=max_candidates,
                          max_sections=max_sections),
                  in_axes=(0, None, None))
    if mesh is None:
        return jax.jit(fn)
    # DP via shard_map, not vmap+pjit sharding: each device compiles the
    # LOCAL (B/ndev, n) program — identical in shape (and hence bitwise in
    # result, see dsp/iir.py) to a single-device run of its rows, and with
    # zero collectives (utterances are independent).  Under plain pjit the
    # partitioner would instead spread every per-row op across the mesh.
    # check_vma off: the local program is collective-free by design and its
    # scans carry unvarying literals into varying carries, which the
    # varying-manual-axes analysis would reject
    return jax.jit(jax.shard_map(fn, mesh=mesh,
                                 in_specs=(P("data", None), P(), P()),
                                 out_specs=P("data"), check_vma=False))


def batch_encode_decode_ragged(xs, fs: int, mesh: Mesh = None,
                               frame_period: int = 5, seed: int = 0,
                               bucket_quantum_s: float = 1.0,
                               check_capacity: bool = True):
    """Full encode+decode for a RAGGED batch (unequal-length utterances).

    A real serving batch is ragged; the reference has no batch API at all.
    Utterances are grouped into length buckets (padded up to the next
    multiple of ``bucket_quantum_s`` seconds), each bucket runs through
    :func:`batch_encode_decode` as one rectangular program, and outputs are
    stripped back to each utterance's own frame/sample counts.

    Semantics: each utterance is analyzed as if zero-padded to its bucket
    length.  All-zeros tails analyze as unvoiced (asserted on the card by
    chip_smoke.py's zeros check), and the stripped outputs cover only
    the utterance's own duration.  Within a bucket, rows are bitwise
    identical to a single-stream run at the same padded length (the
    determinism contract of dsp/iir.py's rank canonicalization) — asserted
    row-for-row by tests/test_aux.py.

    Returns a list of per-utterance dicts (f0, vuv, spectrogram,
    band_aperiodicity, y), in input order.
    """
    xs = [np.asarray(x, np.float32) for x in xs]
    lens = [int(x.shape[0]) for x in xs]
    fp = int(frame_period)
    quantum = max(1, int(round(bucket_quantum_s * fs)))
    buckets = {}
    for i, n in enumerate(lens):
        L = max(quantum, -(-n // quantum) * quantum)
        buckets.setdefault(L, []).append(i)

    n_dev = mesh.devices.size if mesh is not None else 1
    results = [None] * len(xs)
    for L, idxs in sorted(buckets.items()):
        rows = len(idxs)
        pad_rows = (-rows) % n_dev   # shard_map needs divisibility
        xb = np.zeros((rows + pad_rows, L), np.float32)
        for r, i in enumerate(idxs):
            xb[r, : lens[i]] = xs[i]
        out = batch_encode_decode(xb, fs, mesh=mesh, frame_period=fp,
                                  seed=seed, check_capacity=check_capacity)
        for r, i in enumerate(idxs):
            n_i = lens[i]
            nf = int(1000 * n_i / fs / fp + 1)
            y_len = int(np.floor((nf - 1) * fp / 1000 * fs)) + 1
            results[i] = {
                "f0": np.asarray(out["f0"][r])[:nf],
                "vuv": np.asarray(out["vuv"][r])[:nf],
                "spectrogram": np.asarray(out["spectrogram"][r])[:nf],
                "band_aperiodicity":
                    np.asarray(out["band_aperiodicity"][r])[:nf],
                "y": np.asarray(out["y"][r])[:y_len],
            }
    return results


def _warn_batch_capacity(overflow, max_sections, max_pulses):
    """Surface per-utterance static-table saturation (the reference's tables
    are unbounded, /root/reference/world/harvest.py:88-110; ours are static
    and must never truncate silently)."""
    overflow = np.asarray(overflow)
    if overflow.any():
        import warnings

        idx = np.flatnonzero(overflow)
        warnings.warn(
            f"batch_encode_decode: static table capacity "
            f"(max_sections={max_sections}, refinement slots, or "
            f"max_pulses={max_pulses}) saturated for utterance(s) "
            f"{idx.tolist()}; results for those rows may degrade — "
            f"raise the caps", RuntimeWarning, stacklevel=3)


def frame_sharded_cheaptrick(x, f0, vuv, temporal_positions, fs: int,
                             mesh: Mesh, fft_size: int = None):
    """Sequence-parallel CheapTrick: the frame axis is sharded over the mesh;
    each device analyzes its frame block against the replicated signal, then
    the envelope comes back frame-sharded, with a psum across the shards."""
    if fft_size is None:
        fft_size = default_fft_size(fs)
    n_dev = mesh.devices.size
    n_frames = f0.shape[0]
    pad = (-n_frames) % n_dev
    f0_p = jnp.pad(jnp.where(vuv == 0, 500.0, f0), (0, pad),
                   constant_values=500.0)
    tp_p = jnp.pad(temporal_positions, (0, pad))

    def local(xl, f0l, tpl):
        env, _, _ = _cheaptrick_core(xl, int(fs), f0l, tpl, int(fft_size), -0.15)
        # a cross-device collective over the frame shards
        total_energy = jax.lax.psum(jnp.sum(env), "data")
        return env, total_energy

    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=(P(), P("data"), P("data")),
                       out_specs=(P("data"), P()))
    env, total_energy = fn(x, f0_p, tp_p)
    return env[:n_frames], total_energy
