"""Dump the f64 reference harvest's candidate/score stages on a fixture.

Replays /root/reference/world/harvest.py:17-56 stage by stage (via the test
shim) and saves the post-RemoveUnreliable candidates + scores plus the
SearchF0Base argmax picks, so float32 decision margins can be measured
against the true f64 margins (HOW CLOSE the calls were in f64).

Usage: python tools/dump_ref_stages.py tests/golden/harvest_16k.npz out.npz
"""
import sys

import numpy as np

sys.path.insert(0, "/root/repo/tests")
import ref_shim

ref_shim.install()

sys.path.insert(0, "/root/reference")
from world import harvest as H  # noqa: E402


def main(fixture, out_path):
    g = np.load(fixture)
    fs = int(g["fs"])
    x = np.asarray(g["x16"] if "x16" in g else g["x"], np.float64)
    f0_floor, f0_ceil = 71, 800

    num_samples = int(1000 * len(x) / fs / 1 + 1)
    tpos = np.arange(0, num_samples) * 1 / 1000
    boundary = np.arange(np.ceil(np.log2(f0_ceil * 1.1 / (f0_floor * 0.9))
                                 * 40)) + 1
    boundary = (2.0 ** (boundary / 40)) * f0_floor * 0.9
    y, actual_fs = H.CalculateDownsampledSignal(x, fs, 8000)
    fft_size = int(2 ** np.ceil(np.log2(
        len(y) + int(fs / (f0_floor * 0.9) * 4 + 0.5) + 1)))
    y_spectrum = np.fft.fft(y, fft_size)
    raw = H.CalculateCandidates(len(tpos), boundary, len(y), tpos,
                                actual_fs, y_spectrum, f0_floor, f0_ceil)
    cands, n_cands = H.DetectCandidates(raw)
    cands = H.OverlapF0Candidates(cands, n_cands)
    cands, scores = H.RefineCandidates(y, actual_fs, tpos, cands,
                                       f0_floor, f0_ceil)
    cands, scores = H.RemoveUnreliableCandidates(cands, scores)
    base = H.SearchF0Base(cands, scores)
    np.savez(out_path, raw=raw, cands=cands, scores=scores, base=base,
             argmax=scores.argmax(axis=0))
    print(f"saved f64 stages -> {out_path}: cands {cands.shape}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
