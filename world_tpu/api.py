"""Public API facade: the `World` class.

Mirrors the reference surface (/root/reference/world/main.py:26-384): same
method names, same dict contract (numpy in / numpy out at the boundary).
Inside, every pipeline is a jit-compiled JAX program.  Unlike the reference,
analysis methods never mutate their inputs.
"""
import logging

import jax.numpy as jnp
import numpy as np

from .aperiodicity.d4c import d4c
from .features import codecs
from .f0.dio import dio
from .f0.stonemask import stonemask
from .spectral.cheaptrick import cheaptrick
from .synth.classic import synthesis

logger = logging.getLogger(__name__)


def _np(d):
    return {k: np.asarray(v) if isinstance(v, jnp.ndarray) else v
            for k, v in d.items()}


class World:
    """WORLD vocoder: analysis / modification / synthesis / feature codecs."""

    # ------------------------------------------------------------------ F0
    def get_f0(self, fs, x, f0_method="harvest", f0_floor=71, f0_ceil=800,
               channels_in_octave=2, target_fs=4000, frame_period=5):
        source = self._run_f0(fs, x, f0_method, f0_floor, f0_ceil,
                              channels_in_octave, target_fs, frame_period, 0.1)
        return (np.asarray(source["temporal_positions"]),
                np.asarray(source["f0"]), np.asarray(source["vuv"]))

    def _run_f0(self, fs, x, f0_method, f0_floor, f0_ceil, channels_in_octave,
                target_fs, frame_period, allowed_range):
        if f0_method == "dio":
            source = dio(x, fs, f0_floor=f0_floor, f0_ceil=f0_ceil,
                         channels_in_octave=channels_in_octave,
                         target_fs=target_fs, frame_period=frame_period,
                         allowed_range=allowed_range)
            source = dict(source)
            source["f0"] = stonemask(x, fs, source["temporal_positions"],
                                     source["f0"], f0_floor=f0_floor)
        elif f0_method == "harvest":
            from .f0.harvest import harvest
            source = harvest(x, fs, f0_floor=f0_floor, f0_ceil=f0_ceil,
                             frame_period=frame_period)
        elif f0_method == "swipe":
            from .f0.swipe import swipe
            source = swipe(fs, x, plim=[f0_floor, f0_ceil], sTHR=0.3)
        else:
            raise ValueError(f"unknown f0_method {f0_method!r}")
        return source

    # ------------------------------------------------------------- analysis
    def get_spectrum(self, fs, x, f0_method="harvest", f0_floor=71, f0_ceil=800,
                     channels_in_octave=2, target_fs=4000, frame_period=5,
                     fft_size=None):
        source = self._run_f0(fs, x, f0_method, f0_floor, f0_ceil,
                              channels_in_octave, target_fs, frame_period, 0.1)
        filt = cheaptrick(x, fs, source, fft_size=fft_size)
        return _np({
            "f0": source["f0"],
            "temporal_positions": source["temporal_positions"],
            "fs": fs,
            "ps spectrogram": filt["ps spectrogram"],
            "spectrogram": filt["spectrogram"],
        })

    def encode_w_gvn_f0(self, fs, x, source, fft_size=None, is_requiem=False):
        if fft_size is None:
            # deliberate divergence: the reference crashes here on
            # fft_size=None (main.py:90 divides by None); default to the
            # CheapTrick size instead
            from .spectral.cheaptrick import default_fft_size
            fft_size = default_fft_size(fs)
        f0 = np.asarray(source["f0"])
        f0_floor = 3.0 * fs / fft_size
        voiced = f0[f0 > 0]
        if voiced.size and voiced.min() < f0_floor:
            raise ValueError(
                f"given f0 has voiced frames below the floor implied by "
                f"fft_size={fft_size} (3*fs/fft_size = {f0_floor:.2f} Hz; "
                f"min voiced f0 = {voiced.min():.2f} Hz); use a larger "
                f"fft_size")
        filt = cheaptrick(x, fs, source, fft_size=fft_size)
        src2 = dict(source)
        src2["f0"] = filt["f0_effective"]  # the contract the reference's
        # in-place mutation produces: cheaptrick raises unvoiced f0 to 500
        # before d4c re-zeroes it by vuv
        if is_requiem:
            from .aperiodicity.d4c_requiem import d4c_requiem
            src2 = d4c_requiem(x, fs, src2, fft_size=fft_size)
        else:
            src2 = d4c(x, fs, src2, fft_size_for_spectrum=fft_size)
        return _np({
            "temporal_positions": source["temporal_positions"],
            "vuv": source["vuv"],
            "f0": src2["f0"],
            "fs": fs,
            "spectrogram": filt["spectrogram"],
            "aperiodicity": src2["aperiodicity"],
            "coarse_ap": src2.get("coarse_ap"),
            "is_requiem": is_requiem,
        })

    def encode(self, fs, x, f0_method="harvest", f0_floor=71, f0_ceil=800,
               channels_in_octave=2, target_fs=4000, frame_period=5,
               allowed_range=0.1, fft_size=None, is_requiem=False):
        """Speech -> {f0, vuv, spectrogram, aperiodicity} (main.py:106-152)."""
        if fft_size is not None:
            f0_floor = 3.0 * fs / fft_size
        source = self._run_f0(fs, x, f0_method, f0_floor, f0_ceil,
                              channels_in_octave, target_fs, frame_period,
                              allowed_range)
        filt = cheaptrick(x, fs, source, fft_size=fft_size)
        src2 = dict(source)
        src2["f0"] = filt["f0_effective"]
        if is_requiem:
            from .aperiodicity.d4c_requiem import d4c_requiem
            src2 = d4c_requiem(x, fs, src2, fft_size=fft_size)
        else:
            src2 = d4c(x, fs, src2, fft_size_for_spectrum=fft_size)
        return _np({
            "temporal_positions": src2["temporal_positions"],
            "vuv": src2["vuv"],
            "fs": filt["fs"],
            "f0": src2["f0"],
            "aperiodicity": src2["aperiodicity"],
            "ps spectrogram": filt["ps spectrogram"],
            "spectrogram": filt["spectrogram"],
            "is_requiem": is_requiem,
        })

    # ---------------------------------------------------------- modification
    def scale_pitch(self, dat, factor):
        dat["f0"] = np.asarray(dat["f0"]) * factor
        return dat

    def set_pitch(self, dat, time, value):
        raise NotImplementedError  # parity: unimplemented in the reference
        # (main.py:164-168)

    def scale_duration(self, dat, factor):
        dat["temporal_positions"] = np.asarray(dat["temporal_positions"]) * factor
        return dat

    def modify_duration(self, dat, from_time, to_time):
        """Piecewise-linear time warping (main.py:180-189).

        Deliberate divergence: the reference pads ``from_time`` with the
        endpoints but not ``to_time``, so its ``np.interp`` call crashes on
        a length mismatch (main.py:186-189; its only caller is disabled,
        example/prosody.py:39-44).  Here the anchors are 0 -> 0, each
        ``from_time[i]`` -> ``to_time[i]``, and the warp continues at unit
        rate after the last anchor (so the output ends at
        ``to_time[-1] + (end - from_time[-1])``).  A trailing ``-1`` in
        ``to_time`` pins the last anchor to the identity
        (``from_time[-1] -> from_time[-1]``): with the unit-rate tail the
        original end then maps to itself and total duration is preserved.
        """
        tp = np.asarray(dat["temporal_positions"])
        end = tp[-1]
        from_time = np.asarray(from_time, dtype=np.float64)
        to_time = np.asarray(to_time, dtype=np.float64)
        if to_time[-1] == -1:
            to_time[-1] = from_time[-1]
        assert np.all(np.diff(from_time) > 0)
        assert np.all(np.diff(to_time) > 0)
        assert from_time[0] > 0 and to_time[0] > 0
        assert from_time[-1] < end
        xp = np.r_[0.0, from_time, end]
        fp = np.r_[0.0, to_time, to_time[-1] + (end - from_time[-1])]
        dat["temporal_positions"] = np.interp(tp, xp, fp)

    def warp_spectrum(self, dat, factor):
        """Frequency-warp each frame's envelope (main.py:191-196)."""
        spec = jnp.asarray(dat["spectrogram"]).T  # (frames, bins)
        n = spec.shape[1]
        grid = jnp.arange(n) / n
        warped = codecs._interp_rows(grid ** factor, grid, spec)
        dat["spectrogram"] = np.asarray(warped.T)
        return dat

    # -------------------------------------------------------------- synthesis
    def decode(self, dat, key=None, seed=0, noise_offsets=None):
        """WORLD components -> waveform (main.py:198-214).

        ``key`` drives the classic path's noise; ``seed`` selects the requiem
        excitation seed bank and ``noise_offsets`` (one int per band) the
        velvet-noise read cursors.  The reference regenerates seeds
        nondeterministically every call (main.py:205); here variation is
        explicit and reproducible.
        """
        if dat.get("is_requiem"):
            from .synth.requiem import synthesis_requiem
            from .synth.seeds import get_seeds_signals
            seeds = get_seeds_signals(int(dat["fs"]), seed=seed)
            y = synthesis_requiem(dat, dat, seeds,
                                  noise_offsets=noise_offsets)
        else:
            y = synthesis(dat, dat, key=key)
        y = np.asarray(y)
        m = np.max(np.abs(y))
        if m > 1.0:
            logger.info("rescaling waveform")
            y = y / m
        dat["out"] = y
        return dat

    # ------------------------------------------------------- persistence
    @staticmethod
    def save(dat, path):
        """Serialize an analysis dict (the reference's users np.save by hand;
        the dict of arrays is the only stateful artifact — the library itself
        is stateless per call)."""
        arrays = {k: np.asarray(v) for k, v in dat.items()
                  if isinstance(v, (np.ndarray, jnp.ndarray))}
        scalars = {k: v for k, v in dat.items()
                   if not isinstance(v, (np.ndarray, jnp.ndarray))}
        np.savez_compressed(path, __scalars__=np.asarray([repr(scalars)]),
                            **arrays)

    @staticmethod
    def load(path):
        import ast

        g = np.load(path, allow_pickle=False)
        out = {k: g[k] for k in g.files if k != "__scalars__"}
        out.update(ast.literal_eval(str(g["__scalars__"][0])))
        return out

    # ------------------------------------------------------------------ viz
    def draw(self, x, dat):
        """Visualize WORLD components (main.py:216-257)."""
        import sys
        from matplotlib import pyplot as plt

        fs = dat["fs"]
        time = dat["temporal_positions"]
        y = dat["out"]
        fig, ax = plt.subplots(nrows=5, figsize=(8, 6), sharex=True)
        ax[0].set_title("input signal and resynthesized-signal")
        ax[0].plot(np.arange(len(x)) / fs, x, alpha=0.5)
        ax[0].plot(np.arange(len(y)) / fs, y, alpha=0.5)
        ax[0].legend(["original", "synthesis"])
        X = np.asarray(dat["ps spectrogram"])
        X = np.where(X == 0, sys.float_info.epsilon, X)
        ax[1].set_title("pitch-synchronous spectrogram")
        ax[1].imshow(20 * np.log10(np.abs(X[: X.shape[0] // 2, :])),
                     cmap=plt.cm.gray_r, origin="lower",
                     extent=[0, len(x) / fs, 0, fs / 2], aspect="auto")
        ax[2].set_title("phase spectrogram")
        ax[2].imshow(np.diff(np.unwrap(np.angle(X[: X.shape[0] // 2, :]), axis=1),
                             axis=1), cmap=plt.cm.gray_r, origin="lower",
                     extent=[0, len(x) / fs, 0, fs / 2], aspect="auto")
        ax[3].set_title("WORLD spectrogram")
        Y = np.asarray(dat["spectrogram"])
        Y = np.where(Y < sys.float_info.epsilon, sys.float_info.epsilon, Y)
        ax[3].imshow(20 * np.log10(Y), cmap=plt.cm.gray_r, origin="lower",
                     extent=[0, len(x) / fs, 0, fs / 2], aspect="auto")
        ax[4].set_title("WORLD fundamental frequency")
        ax[4].plot(time, dat["f0"])
        plt.show()

    # --------------------------------------------------------- feature codecs
    def hz2mel(self, hz):
        return np.asarray(codecs.hz2mel(hz))

    def mel2hz(self, mel):
        return np.asarray(codecs.mel2hz(mel))

    def get_filterbanks(self, nfilt=20, nfft=512, samplerate=16000, lowfreq=0,
                        highfreq=None):
        return np.asarray(codecs.get_filterbanks(nfilt, nfft, samplerate,
                                                 lowfreq, highfreq))

    def encode_lfbank(self, spec, prefac=0.97, fs=16000, nfilt=32, lowfreq=0,
                      highfreq=None):
        return np.asarray(codecs.encode_lfbank(spec, prefac, fs, nfilt,
                                               lowfreq, highfreq))

    def encode_mcep(self, spec, n0=12, fs=16000, lowhz=0, highhz=8000):
        return np.asarray(codecs.encode_mcep(spec, n0, fs, lowhz, highhz))

    def decode_mcep(self, cepstrum, fft_size):
        return np.asarray(codecs.decode_mcep(cepstrum, fft_size))

    def get_context(self, X, w=5):
        return np.asarray(codecs.get_context(X, w))

    def encode_vae(self, Xc, energy, encoder, decoder, window, n0, batch_size,
                   mean):
        return codecs.encode_vae(Xc, energy, encoder, decoder, window, n0,
                                 batch_size, mean)
