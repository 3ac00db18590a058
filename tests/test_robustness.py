"""Capacity-overflow surfacing, long-audio blocking, and API robustness.

The reference's candidate/section/pulse tables are unbounded Python lists
(/root/reference/world/harvest.py:88-110, synthesis.py:128-131); ours are
static.  These tests prove saturation is *surfaced*, never silent, and that
the deliberate API divergences (encode_w_gvn_f0 fft_size default, requiem
decode determinism) behave as documented.
"""
from pathlib import Path

import numpy as np
import pytest

GOLDEN = Path(__file__).parent / "golden"


@pytest.mark.smoke
def test_fir_blocked_matches_single_shot():
    """Blocked overlap-add FIR (the minutes-long-audio path) must equal the
    one-shot im2col convolution, including across chunk joins."""
    import jax.numpy as jnp

    from world_tpu.dsp.fir import fir_bank_full

    rng = np.random.RandomState(0)
    y = jnp.asarray(rng.randn(5000))
    bank = jnp.asarray(rng.randn(3, 101))
    a = np.asarray(fir_bank_full(y, bank))
    b = np.asarray(fir_bank_full(y, bank, block=512))
    # block=512 with L=101: every chunk join exercised, incl. a ragged tail
    assert a.shape == b.shape == (3, 5100)
    np.testing.assert_allclose(b, a, atol=1e-12)


def test_band_chunked_candidates_match_unchunked():
    """The lax.map band-chunked candidate path (minutes-long-audio memory
    bound) must reproduce the all-bands path, including ragged tail chunks
    and the padded zero-filter rows."""
    import jax.numpy as jnp

    from world_tpu.f0.harvest import downsample, raw_band_candidates

    fs = 22050
    rng = np.random.RandomState(0)
    t = np.arange(fs) / fs  # 1 s
    x = np.sin(2 * np.pi * 160 * t) + 0.3 * np.sin(2 * np.pi * 320 * t)
    x += 0.01 * rng.randn(fs)
    y, afs = downsample(jnp.asarray(x), fs, 8000)
    n_frames = int(1000 * len(x) / fs + 1)
    tp = jnp.asarray(np.arange(n_frames) / 1000)
    adj_f, adj_c = 71 * 0.9, 800 * 1.1
    bfl = adj_f * 2.0 ** (
        (np.arange(np.ceil(np.log2(adj_c / adj_f) * 40)) + 1) / 40)
    a = np.asarray(raw_band_candidates(y, afs, bfl, tp, 71, 800, 0, 0))
    # 152 bands / chunk 48 -> 4 chunks with a 40-row padded tail
    b = np.asarray(raw_band_candidates(y, afs, bfl, tp, 71, 800, 0, 0,
                                       band_chunk=48))
    assert a.shape == b.shape == (152, n_frames)
    np.testing.assert_allclose(b, a, atol=1e-9)


def test_smooth_f0_section_chunked_matches_single_block():
    """smooth_f0's lax.scan section chunking (memory bound for minutes-long
    audio: a dense (max_sections, n) row matrix is O(n^2/32) with the
    adaptive table) must be BITWISE identical to the single-block path —
    sections are disjoint, so the blockwise accumulation adds only zeros."""
    import jax.numpy as jnp

    from world_tpu.f0.harvest import smooth_f0

    rng = np.random.RandomState(0)
    f0 = np.zeros(4000)
    st = 5
    for _ in range(37):  # 37 sections of random length/gap
        ln = rng.randint(3, 120)
        f0[st: st + ln] = 100 + 50 * rng.rand()
        st += ln + rng.randint(2, 40)
        if st >= len(f0) - 5:
            break
    f0 = jnp.asarray(f0)
    one = np.asarray(smooth_f0(f0, max_sections=64, section_chunk=64))
    chunked = np.asarray(smooth_f0(f0, max_sections=64, section_chunk=16))
    # 64 sections / chunk 16 -> 4 scan steps, incl. invalid padded rows
    assert np.array_equal(one, chunked)


@pytest.mark.smoke
def test_harvest_adaptive_max_sections():
    """max_sections=None scales with signal length (a 60 s input needs
    ~1400 pre-merge section slots; a fixed 256 truncated voicing past
    ~11 s on the 60 s glide probe)."""
    from world_tpu.f0.harvest import default_max_sections

    assert default_max_sections(22050, 22050) == 256        # 1 s -> floor
    assert default_max_sections(102400, 22050) == 256       # fixture -> floor
    assert default_max_sections(60 * 22050, 22050) > 1500   # 60 s -> scaled


@pytest.mark.smoke
def test_encode_w_gvn_f0_floor_check_is_readable():
    """f0 below 3*fs/fft_size raises ValueError (not a bare assert)."""
    from world_tpu import World

    source = {
        "f0": np.full(9, 40.0),  # below 3*22050/1024 = 64.6 Hz
        "vuv": np.ones(9),
        "temporal_positions": np.arange(9) * 0.005,
    }
    with pytest.raises(ValueError, match="fft_size"):
        World().encode_w_gvn_f0(22050, np.zeros(1000), source, fft_size=1024)


def test_encode_w_gvn_f0_defaults_fft_size(speech16k):
    """fft_size=None must default to the CheapTrick size instead of crashing
    (the reference divides by None at main.py:90 — deliberate divergence)."""
    from world_tpu import World

    fs, x = speech16k
    src = np.load(GOLDEN / "source_dio.npz")
    source = {k: src[k] for k in src.files}
    dat = World().encode_w_gvn_f0(fs, x, source, fft_size=None)
    assert dat["spectrogram"].shape[0] == 513
    assert dat["aperiodicity"].shape == dat["spectrogram"].shape
    assert np.all(np.isfinite(dat["spectrogram"]))


@pytest.mark.smoke
def test_synthesis_pulse_overflow_warns(monkeypatch):
    """An undersized pulse table must warn, not silently truncate.

    The overflow *detection* (raw pulse count vs the static table) is
    checked against _time_base directly on a tiny contour; the warn plumbing
    is checked by stubbing the synthesis core (compiling a full synthesis
    program with a tiny max_pulses would cost minutes of suite time for the
    same coverage)."""
    import jax
    import jax.numpy as jnp

    from world_tpu.synth import classic

    # 1 s of 200 Hz voiced speech -> ~200 pulses; cap at 8
    fs = 8000.0
    tp = jnp.asarray(np.arange(201) * 0.005)
    f0 = jnp.full(201, 200.0)
    vuv = jnp.ones(201)
    time_axis = jnp.arange(8001) / fs
    max_pulses = 8
    *_, count, raw_count = classic._time_base(
        tp, f0, vuv, fs, time_axis, 500.0, max_pulses, np.pi, 0.005)
    assert int(raw_count) > max_pulses
    assert int(count) == max_pulses

    calls = {}

    def stub_core(*args, **kwargs):
        calls["hit"] = True
        return jnp.zeros(16), jnp.asarray(True)

    monkeypatch.setattr(classic, "_synthesis_core", stub_core)
    dat = {"f0": np.full(9, 100.0), "vuv": np.ones(9),
           "temporal_positions": np.arange(9) * 0.005,
           "spectrogram": np.ones((513, 9)),
           "aperiodicity": np.full((513, 9), 0.5), "fs": 22050}
    with pytest.warns(RuntimeWarning, match="max_pulses"):
        classic.synthesis(dat, dat, max_pulses=64)
    assert calls["hit"]


@pytest.mark.smoke
def test_synthesis_pulse_overflow_real_program():
    """A REAL classic-synthesis program whose pulse table genuinely
    saturates, end-to-end: 0.5 s of 150 Hz voiced speech (~75 pulses) vs
    max_pulses=32.  The warning must fire AND the (truncated) output must
    stay finite — the reference's pulse list is unbounded
    (/root/reference/world/synthesis.py:128-131); ours is static.  Tiny
    shapes (fs=8000, fft_size=512) keep the compile to seconds."""
    from world_tpu.synth.classic import synthesis

    fs, nf = 8000, 101  # 0.5 s at 5 ms frames
    rng = np.random.RandomState(0)
    spec = np.abs(rng.randn(257, nf)) * 1e-4 + 1e-6
    dat = {"f0": np.full(nf, 150.0), "vuv": np.ones(nf),
           "temporal_positions": np.arange(nf) * 0.005,
           "spectrogram": spec,
           "aperiodicity": np.full((257, nf), 0.1), "fs": fs}
    with pytest.warns(RuntimeWarning, match="max_pulses"):
        y = synthesis(dat, dat, max_pulses=32)
    y = np.asarray(y)
    # reference time base: arange(tp[0], tp[-1] + 1/fs, 1/fs) -> n+2 samples
    assert y.shape[0] == int(0.5 * fs) + 2
    assert np.all(np.isfinite(y))
    assert np.abs(y).max() > 0  # the kept 32 pulses still produced signal


@pytest.mark.smoke
def test_tiny_requiem_roundtrip_smoke():
    """One flagship harvest->cheaptrick->d4cRequiem->synthesisRequiem
    round-trip at tiny static shapes (fs=12000, 0.256 s, small caps) so the
    smoke tier drives a REAL encode+decode program end-to-end.  Same shapes
    as the driver's dryrun_multichip DP row, so the compile stays ~1 min
    cold and seconds warm-cache."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from world_tpu.parallel.batch import _encode_decode_one
    from world_tpu.synth.seeds import get_seeds_signals

    fs, n = 12000, 3072
    t = np.arange(n) / fs
    rng = np.random.RandomState(0)
    # the 1% noise floor matters: on a PURE stationary tone the reference's
    # own RemoveUnreliableCandidates wipes all but ~2 frames (verified
    # parity-exact against /root/reference on this clip) — real signals
    # (and the driver dryrun) always carry noise
    x = jnp.asarray((0.6 * (np.sin(2 * np.pi * 150 * t)
                            + 0.3 * np.sin(2 * np.pi * 300 * t))
                     + 0.01 * rng.randn(n)).astype(np.float32))
    seeds = get_seeds_signals(fs)
    pulse = jnp.asarray(np.asarray(seeds["pulse"], np.float32))
    noise = jnp.asarray(np.asarray(seeds["noise"], np.float32))
    out = jax.jit(partial(_encode_decode_one, fs=fs, frame_period=10,
                          max_pulses=256, max_candidates=8,
                          max_sections=16))(x, pulse, noise)
    f0 = np.asarray(out["f0"])
    y = np.asarray(out["y"])
    assert np.all(np.isfinite(y)) and np.abs(y).max() > 0
    voiced = f0[f0 > 0]
    assert voiced.size > 10
    med = float(np.median(voiced))
    assert 140 < med < 160, med  # the 150 Hz fundamental must be found


@pytest.mark.smoke
def test_tiny_dio_classic_roundtrip_smoke():
    """One dio+stonemask -> classic pulse/noise synthesis round-trip at the
    same tiny shapes (the BASELINE config-2 path, end-to-end in smoke)."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from world_tpu.parallel.batch import _encode_decode_classic_one

    fs, n = 12000, 3072
    t = np.arange(n) / fs
    rng = np.random.RandomState(0)
    x = jnp.asarray((0.6 * (np.sin(2 * np.pi * 150 * t)
                            + 0.3 * np.sin(2 * np.pi * 300 * t))
                     + 0.01 * rng.randn(n)).astype(np.float32))
    out = jax.jit(partial(_encode_decode_classic_one, fs=fs,
                          frame_period=10))(x, jax.random.PRNGKey(0))
    f0 = np.asarray(out["f0"])
    y = np.asarray(out["y"])
    assert np.all(np.isfinite(y)) and np.abs(y).max() > 0
    voiced = f0[f0 > 0]
    assert voiced.size > 10
    med = float(np.median(voiced))
    assert 140 < med < 160, med


@pytest.mark.smoke
def test_harvest_capacity_warnings():
    """Static-table saturation must warn, never silently truncate.

    The flag *computation* lives in _harvest_core (exercised by the golden
    runs, which assert no overflow on the fixture); here the warn surface is
    driven directly so the suite does not pay a fresh multi-minute pipeline
    compile for a tiny-cap configuration."""
    from world_tpu.f0.harvest import _warn_capacity

    with pytest.warns(RuntimeWarning, match="refinement"):
        _warn_capacity(True, False, 256)
    with pytest.warns(RuntimeWarning, match="max_sections"):
        _warn_capacity(False, True, 2)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _warn_capacity(False, False, 256)  # no warning


def test_requiem_decode_seed_and_offsets():
    """decode(seed=, noise_offsets=) is deterministic per seed and varies
    across seeds/offsets (the reference is nondeterministic every call,
    main.py:205 — improved, not copied)."""
    from world_tpu import World

    g = np.load(GOLDEN / "d4c_requiem.npz")
    s = np.load(GOLDEN / "source_harvest.npz")
    ct = np.load(GOLDEN / "cheaptrick.npz")
    n = len(s["f0"])
    dat = {
        "f0": s["f0"],
        "vuv": s["vuv"],
        "temporal_positions": s["temporal_positions"],
        "spectrogram": ct["spectrogram"][:, :n] if ct["spectrogram"].shape[1] != n
        else ct["spectrogram"],
        "aperiodicity": g["band_aperiodicity"],
        "fs": 22050,
        "is_requiem": True,
    }
    w = World()
    y0 = w.decode(dict(dat), seed=0)["out"]
    y0b = w.decode(dict(dat), seed=0)["out"]
    np.testing.assert_array_equal(y0, y0b)
    y1 = w.decode(dict(dat), seed=1)["out"]
    assert not np.allclose(y0, y1)
    off = np.full(int(np.asarray(dat["aperiodicity"]).shape[0]), 1000,
                  dtype=np.int32)
    y2 = w.decode(dict(dat), seed=0, noise_offsets=off)["out"]
    assert not np.allclose(y0, y2)


def test_modify_duration_then_decode():
    """modify_duration produces a non-uniform time grid; decode must handle
    it (the reference demo's disabled branch, example/prosody.py:39-44)."""
    from world_tpu import World

    src = np.load(GOLDEN / "source_dio.npz")
    ct = np.load(GOLDEN / "cheaptrick.npz")
    d4 = np.load(GOLDEN / "d4c.npz")
    dat = {
        "f0": d4["f0_after_mutation"],
        "vuv": src["vuv"],
        "temporal_positions": src["temporal_positions"].copy(),
        "spectrogram": ct["spectrogram"],
        "aperiodicity": d4["aperiodicity"],
        "fs": 22050,
        "is_requiem": False,
    }
    w = World()
    end = dat["temporal_positions"][-1]
    w.modify_duration(dat, [1.0, end - 1.0], [0.7, -1])
    tp = dat["temporal_positions"]
    assert not np.allclose(np.diff(tp), np.diff(tp)[0])  # non-uniform now
    # trailing -1 pins the last anchor to the identity: total duration kept
    np.testing.assert_allclose(tp[-1], end, atol=1e-9)
    out = w.decode(dat)["out"]
    assert np.all(np.isfinite(out))
    assert 0.001 < np.abs(out).max() <= 1.0
