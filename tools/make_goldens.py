"""Generate golden parity fixtures from the shimmed NumPy reference.

Runs the reference pipeline on test-mwm.wav, capturing per-stage
intermediates, and stores them under tests/golden/*.npz.  One-time (results
are committed); tests load the npz files only.

Usage: python tools/make_goldens.py [dio|stonemask|cheaptrick|d4c|synthesis|
                                     harvest|requiem|all]
"""
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))
import ref_shim

GOLDEN = Path(__file__).resolve().parent.parent / "tests" / "golden"
GOLDEN.mkdir(parents=True, exist_ok=True)


def load_x():
    from scipy.io import wavfile

    fs, x = wavfile.read("/root/reference/test/test-mwm.wav")
    return fs, x.astype(np.float64) / (2 ** 15 - 1)


def gen_dio():
    w = ref_shim.reference_world()
    from world import dio as D

    fs, x = load_x()
    t0 = time.time()
    # replicate dio() glue (world/dio.py:10-55) capturing intermediates
    import math

    f0_floor, f0_ceil, channels_in_octave, target_fs, frame_period, allowed_range = (
        71, 800, 2, 4000, 5, 0.1)
    num_samples = int(1000 * len(x) / fs / frame_period + 1)
    temporal_positions = np.arange(0, num_samples) * frame_period / 1000
    boundary_f0_list = np.arange(math.ceil(np.log2(f0_ceil / f0_floor) * channels_in_octave)) + 1
    boundary_f0_list = f0_floor * (2.0 ** (boundary_f0_list / channels_in_octave))
    y = D.decimate(x, int(fs / target_fs))
    actual_fs = target_fs
    y_spectrum = D.get_spectrum(y, actual_fs, f0_floor)
    raw_f0_candidate, raw_stability = D.get_candidate_and_stability(
        np.size(temporal_positions), boundary_f0_list, np.size(y), temporal_positions,
        actual_fs, y_spectrum, f0_floor, f0_ceil)
    f0_candidates, f0_scores = D.sort_candidates(raw_f0_candidate, raw_stability)
    f0_candidates_tmp = np.copy(f0_candidates)
    # fix_f0_contour internals (world/dio.py:216-232)
    voice_range_minimum = int(1 / (frame_period / 1000) / f0_floor + 0.5) * 2 + 1
    f0_step1 = D.fix_step1(f0_candidates, voice_range_minimum, allowed_range)
    f0_step2 = D.fix_step2(f0_step1, voice_range_minimum)
    section_list = D.count_voiced_sections(f0_step2)
    f0_step3 = D.fix_step3(f0_step2, f0_candidates, section_list, allowed_range)
    f0_step4 = D.fix_step4(f0_step3, f0_candidates, section_list, allowed_range)
    f0 = np.copy(f0_step4)
    vuv = np.copy(f0)
    vuv[vuv != 0] = 1
    print(f"dio done in {time.time()-t0:.1f}s; voiced {int(vuv.sum())}/{len(vuv)}")
    np.savez_compressed(
        GOLDEN / "dio.npz", fs=fs, y_decimated=y,
        temporal_positions=temporal_positions, boundary_f0_list=boundary_f0_list,
        raw_f0_candidate=raw_f0_candidate, raw_stability=raw_stability,
        f0_candidates=f0_candidates_tmp, f0_scores=f0_scores,
        f0_candidates_mutated=f0_candidates,  # after fix_step1's in-place edge zeroing
        f0_step1=f0_step1, f0_step2=f0_step2, section_list=section_list,
        f0_step3=f0_step3, f0_step4=f0_step4, f0=f0, vuv=vuv)
    return dict(f0=f0, vuv=vuv, temporal_positions=temporal_positions)


def gen_stonemask(dio_out):
    ref_shim.reference_world()
    from world import stonemask as S

    fs, x = load_x()
    t0 = time.time()
    refined = S.stonemask(x, fs, dio_out["temporal_positions"], np.copy(dio_out["f0"]))
    print(f"stonemask done in {time.time()-t0:.1f}s")
    np.savez_compressed(GOLDEN / "stonemask.npz", f0_in=dio_out["f0"],
                        refined_f0=refined)
    return refined


def gen_cheaptrick_d4c_synthesis(source):
    """cheaptrick -> d4c -> synthesis following World.encode/decode order."""
    ref_shim.reference_world()
    from world import cheaptrick as C
    from world import d4c as A
    from world import synthesis as SY

    fs, x = load_x()
    src = {k: np.copy(v) for k, v in source.items()}
    t0 = time.time()
    # deterministic eps instead of random guard (cheaptrick.py:117); keeps
    # golden reproducible, algebraically identical up to <1e-16 noise floor
    _orig_ls = C.linear_smoothing
    import sys as _sys

    def det_linear_smoothing(power_spectrum, f0, fs_, fft_size):
        np.random.seed(12345)
        return _orig_ls(power_spectrum, f0, fs_, fft_size)

    C.linear_smoothing = det_linear_smoothing
    filt = C.cheaptrick(x, fs, src)  # NB mutates src['f0'] unvoiced->500
    C.linear_smoothing = _orig_ls
    print(f"cheaptrick done in {time.time()-t0:.1f}s")
    np.savez_compressed(GOLDEN / "cheaptrick.npz",
                        f0_after_mutation=src["f0"],
                        spectrogram=filt["spectrogram"],
                        ps_spectrogram_abs=np.abs(filt["ps spectrogram"]).astype(np.float32))

    t0 = time.time()
    src2 = {k: np.copy(v) for k, v in src.items()}
    src2 = A.d4c(x, fs, src2)  # mutates f0 unvoiced->0
    print(f"d4c done in {time.time()-t0:.1f}s")
    np.savez_compressed(GOLDEN / "d4c.npz", f0_after_mutation=src2["f0"],
                        aperiodicity=src2["aperiodicity"], coarse_ap=src2["coarse_ap"])

    # deterministic-noise synthesis (noise = const 0.1, the commented-out
    # variant at synthesis.py:94) so the waveform is bit-comparable
    t0 = time.time()
    dat = dict(src2)
    dat["spectrogram"] = filt["spectrogram"]
    dat["fs"] = fs

    def det_aperiodic_response(tmp_aperiodic_spectrum, fft_size, latter_index, noise_size):
        aperiodic_spectrum = np.r_[tmp_aperiodic_spectrum, tmp_aperiodic_spectrum[-2:0:-1]]
        tmp_cepstrum = np.fft.fft((np.log(np.abs(aperiodic_spectrum)) / 2)).real
        tmp_complex_cepstrum = np.zeros(fft_size)
        li = latter_index.astype(int) - 1
        tmp_complex_cepstrum[li] = tmp_cepstrum[li] * 2
        tmp_complex_cepstrum[0] = tmp_cepstrum[0]
        response = np.fft.fftshift(np.fft.ifft(np.exp(np.fft.ifft(tmp_complex_cepstrum))).real)
        noise_input = np.zeros(max(3, noise_size)) + 0.1
        return SY.fftfilt(noise_input - np.mean(noise_input), response)

    orig = SY.get_aperiodic_response
    SY.get_aperiodic_response = det_aperiodic_response
    y = SY.synthesis(dat, dat)
    SY.get_aperiodic_response = orig
    pl, pli, plts, ivuv = SY.time_base_generation(
        dat["temporal_positions"], dat["f0"], fs, dat["vuv"],
        np.arange(dat["temporal_positions"][0], dat["temporal_positions"][-1] + 1 / fs, 1 / fs),
        500)
    print(f"synthesis done in {time.time()-t0:.1f}s; y {y.shape}")
    np.savez_compressed(GOLDEN / "synthesis.npz", y_det=y,
                        pulse_locations=pl, pulse_locations_index=pli,
                        pulse_time_shift=plts)


def gen_harvest():
    ref_shim.reference_world()
    from world import harvest as H

    ref_shim.sequential_refine(H)
    fs, x = load_x()
    t0 = time.time()
    f0_floor, f0_ceil, frame_period = 71, 800, 5
    basic_frame_period = 1
    target_fs = 8000
    num_samples = int(1000 * len(x) / fs / basic_frame_period + 1)
    basic_temporal_positions = np.arange(0, num_samples) * basic_frame_period / 1000
    channels_in_octave = 40
    adj_floor, adj_ceil = f0_floor * 0.9, f0_ceil * 1.1
    boundary_f0_list = np.arange(np.ceil(np.log2(adj_ceil / adj_floor) * channels_in_octave)) + 1
    boundary_f0_list = adj_floor * 2.0 ** (boundary_f0_list / channels_in_octave)
    y, actual_fs = H.CalculateDownsampledSignal(x, fs, target_fs)
    fft_size = int(2 ** np.ceil(np.log2(len(y) + int(fs / adj_floor * 4 + 0.5) + 1)))
    y_spectrum = np.fft.fft(y, fft_size)
    print(f"  downsample done {time.time()-t0:.1f}s  y {y.shape}")
    raw = H.CalculateCandidates(len(basic_temporal_positions), boundary_f0_list, len(y),
                                basic_temporal_positions, actual_fs, y_spectrum,
                                f0_floor, f0_ceil)
    print(f"  candidates done {time.time()-t0:.1f}s")
    f0_candidates0, number_of_candidates = H.DetectCandidates(raw)
    f0_candidates1 = H.OverlapF0Candidates(f0_candidates0, number_of_candidates)
    print(f"  detect/overlap done {time.time()-t0:.1f}s  ncand={number_of_candidates}")
    f0_candidates2, f0_scores2 = H.RefineCandidates(y, actual_fs, basic_temporal_positions,
                                                    f0_candidates1, f0_floor, f0_ceil)
    print(f"  refine done {time.time()-t0:.1f}s")
    f0_candidates3, f0_scores3 = H.RemoveUnreliableCandidates(f0_candidates2, f0_scores2)
    print(f"  remove-unreliable done {time.time()-t0:.1f}s")
    f0_base = H.SearchF0Base(f0_candidates3, f0_scores3)
    f0_step1 = H.FixStep1(f0_base, 0.008)
    f0_step2 = H.FixStep2(f0_step1, 6)
    f0_step3 = H.FixStep3(f0_step2, f0_candidates3, 0.18, f0_scores3)
    f0_step4 = H.FixStep4(f0_step3, 9)
    vuv = np.copy(f0_step4)
    vuv[vuv != 0] = 1
    smoothed_f0 = H.SmoothF0(f0_step4)
    num_samples5 = int(1000 * len(x) / fs / frame_period + 1)
    temporal_positions = np.arange(0, num_samples5) * frame_period / 1000
    idx = np.minimum(len(smoothed_f0) - 1, H.round_matlab(temporal_positions * 1000)).astype(int)
    f0_out = smoothed_f0[idx]
    vuv_out = vuv[idx]
    print(f"harvest done in {time.time()-t0:.1f}s; voiced {int(vuv_out.sum())}/{len(vuv_out)}")
    np.savez_compressed(
        GOLDEN / "harvest.npz", fs=fs, y_decimated=y,
        boundary_f0_list=boundary_f0_list,
        raw_f0_candidates=raw.astype(np.float32),
        f0_candidates_detected=f0_candidates0, n_detected=number_of_candidates,
        f0_candidates_overlap=f0_candidates1,
        f0_candidates_refined=f0_candidates2, f0_scores_refined=f0_scores2,
        f0_candidates_clean=f0_candidates3, f0_scores_clean=f0_scores3,
        f0_base=f0_base, f0_step1=f0_step1, f0_step2=f0_step2,
        f0_step3=f0_step3, f0_step4=f0_step4, smoothed_f0=smoothed_f0,
        temporal_positions=temporal_positions, f0=f0_out, vuv=vuv_out)
    return dict(f0=f0_out, vuv=vuv_out, temporal_positions=temporal_positions)


def gen_harvest_small():
    """1 s @ 16 kHz small-fixture harvest golden for the DEFAULT pytest tier.

    The full-fixture parity suite lives in the slow tier (~8 min XLA-CPU
    compile per program on a 1-core box); this clip keeps a cold default run
    exercising _harvest_core end-to-end.  Input: the first second of the
    16 kHz resampled fixture already committed in harvest_16k.npz."""
    ref_shim.reference_world()
    from world import harvest as H

    ref_shim.sequential_refine(H)
    g16 = np.load(GOLDEN / "harvest_16k.npz")
    fs = int(g16["fs"])
    assert fs == 16000, fs
    x = np.asarray(g16["x16"], np.float64)[:fs]  # first 1.0 s
    t0 = time.time()
    f0_floor, f0_ceil, frame_period = 71, 800, 5
    basic_temporal_positions = np.arange(
        0, int(1000 * len(x) / fs + 1)) / 1000
    adj_floor, adj_ceil = f0_floor * 0.9, f0_ceil * 1.1
    boundary_f0_list = np.arange(
        np.ceil(np.log2(adj_ceil / adj_floor) * 40)) + 1
    boundary_f0_list = adj_floor * 2.0 ** (boundary_f0_list / 40)
    y, actual_fs = H.CalculateDownsampledSignal(x, fs, 8000)
    fft_size = int(2 ** np.ceil(np.log2(
        len(y) + int(fs / adj_floor * 4 + 0.5) + 1)))
    y_spectrum = np.fft.fft(y, fft_size)
    raw = H.CalculateCandidates(len(basic_temporal_positions),
                                boundary_f0_list, len(y),
                                basic_temporal_positions, actual_fs,
                                y_spectrum, f0_floor, f0_ceil)
    f0_candidates0, number_of_candidates = H.DetectCandidates(raw)
    f0_candidates1 = H.OverlapF0Candidates(f0_candidates0,
                                           number_of_candidates)
    f0_candidates2, f0_scores2 = H.RefineCandidates(
        y, actual_fs, basic_temporal_positions, f0_candidates1,
        f0_floor, f0_ceil)
    f0_candidates3, f0_scores3 = H.RemoveUnreliableCandidates(
        f0_candidates2, f0_scores2)
    f0_base = H.SearchF0Base(f0_candidates3, f0_scores3)
    f0_step1 = H.FixStep1(f0_base, 0.008)
    f0_step2 = H.FixStep2(f0_step1, 6)
    f0_step3 = H.FixStep3(f0_step2, f0_candidates3, 0.18, f0_scores3)
    f0_step4 = H.FixStep4(f0_step3, 9)
    vuv = np.copy(f0_step4)
    vuv[vuv != 0] = 1
    smoothed_f0 = H.SmoothF0(f0_step4)
    temporal_positions = np.arange(
        0, int(1000 * len(x) / fs / frame_period + 1)) * frame_period / 1000
    idx = np.minimum(len(smoothed_f0) - 1,
                     H.round_matlab(temporal_positions * 1000)).astype(int)
    f0_out = smoothed_f0[idx]
    vuv_out = vuv[idx]
    print(f"harvest_small done in {time.time()-t0:.1f}s; "
          f"voiced {int(vuv_out.sum())}/{len(vuv_out)}, "
          f"ncand={number_of_candidates}")
    np.savez_compressed(
        GOLDEN / "harvest_small.npz", fs=fs, x=x,
        n_detected=number_of_candidates,
        f0_candidates_refined=f0_candidates2, f0_scores_refined=f0_scores2,
        f0_base=f0_base, f0_step2=f0_step2, f0_step4=f0_step4,
        smoothed_f0=smoothed_f0, temporal_positions=temporal_positions,
        f0=f0_out, vuv=vuv_out)


def gen_requiem(source):
    ref_shim.reference_world()
    import random as pyrandom

    from world import d4cRequiem as DR
    from world import get_seeds_signals as GS
    from world import synthesisRequiem as SR
    from world import cheaptrick as C

    fs, x = load_x()
    src = {k: np.copy(v) for k, v in source.items()}
    t0 = time.time()
    filt = C.cheaptrick(x, fs, src)
    src2 = {k: np.copy(v) for k, v in src.items()}
    src2 = DR.d4cRequiem(x, fs, src2)
    print(f"d4cRequiem done in {time.time()-t0:.1f}s")
    np.savez_compressed(GOLDEN / "d4c_requiem.npz",
                        band_aperiodicity=src2["aperiodicity"])

    pyrandom.seed(7)
    np.random.seed(7)
    seeds = GS.get_seeds_signals(fs)
    SR.generate_noise.current_index = None  # reset the stateful cursor
    t0 = time.time()
    dat = dict(src2)
    dat["spectrogram"] = filt["spectrogram"]
    dat["fs"] = fs
    y = SR.synthesisRequiem(dat, dat, seeds)
    print(f"synthesisRequiem done in {time.time()-t0:.1f}s; y {y.shape}")
    np.savez_compressed(GOLDEN / "requiem_synthesis.npz",
                        pulse_seed=seeds["pulse"], noise_seed=seeds["noise"], y=y)


def gen_swipe():
    """SWIPE' f0 golden (reference swipe.py:9-102) at 22.05 kHz, a committed
    oracle for gates that cannot drive the live shim (tests/test_swipe.py
    does)."""
    ref_shim.reference_world()
    from world import swipe as RS

    fs, x = load_x()
    t0 = time.time()
    ref = RS.swipe(fs, x, [71, 800], 0.005, 0.3)
    print(f"swipe done in {time.time()-t0:.1f}s")
    np.savez_compressed(GOLDEN / "swipe.npz", f0=ref["f0"],
                        temporal_positions=ref["temporal_positions"])


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    dio_out = None
    if which in ("dio", "all", "dio_chain"):
        dio_out = gen_dio()
    if which in ("stonemask", "all", "dio_chain"):
        refined = gen_stonemask(dio_out)
        source = dict(f0=refined, vuv=dio_out["vuv"],
                      temporal_positions=dio_out["temporal_positions"])
        np.savez_compressed(GOLDEN / "source_dio.npz", **source)
    if which in ("cheaptrick", "d4c", "synthesis", "all", "dio_chain"):
        g = np.load(GOLDEN / "source_dio.npz")
        gen_cheaptrick_d4c_synthesis({k: g[k] for k in g.files})
    if which in ("harvest", "all"):
        hv = gen_harvest()
        np.savez_compressed(GOLDEN / "source_harvest.npz", **hv)
    if which in ("harvest_small", "all"):
        gen_harvest_small()
    if which in ("requiem", "all"):
        g = np.load(GOLDEN / "source_harvest.npz")
        gen_requiem({k: g[k] for k in g.files})
    if which in ("swipe", "all"):
        gen_swipe()
    print("goldens written to", GOLDEN)


if __name__ == "__main__":
    main()
