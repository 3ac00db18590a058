"""Feature codecs: mel filterbanks, log-filterbank energies, MCEP, context.

API mirrors /root/reference/world/main.py:259-384 but the loops are batched
jnp ops (matmuls for the filterbank projections).
"""
import jax
import jax.numpy as jnp
import numpy as np


def hz2mel(hz):
    return 2595 * jnp.log10(1 + jnp.asarray(hz) / 700.0)


def mel2hz(mel):
    return 700 * (10 ** (jnp.asarray(mel) / 2595.0) - 1)


def get_filterbanks(nfilt=20, nfft=512, samplerate=16000, lowfreq=0, highfreq=None):
    """Triangular mel filterbank matrix (nfilt, nfft//2+1) (main.py:275-303)."""
    highfreq = highfreq or samplerate / 2
    assert highfreq <= samplerate / 2, "highfreq is greater than samplerate/2"
    lowmel = float(hz2mel(lowfreq))
    highmel = float(hz2mel(highfreq))
    melpoints = np.linspace(lowmel, highmel, nfilt + 2)
    bin_edges = np.floor((nfft + 1) * np.asarray(mel2hz(melpoints)) / samplerate)
    k = np.arange(nfft // 2 + 1)
    lo = bin_edges[:-2][:, None]
    mid = bin_edges[1:-1][:, None]
    hi = bin_edges[2:][:, None]
    rising = (k[None, :] - lo) / np.maximum(mid - lo, 1e-12)
    falling = (hi - k[None, :]) / np.maximum(hi - mid, 1e-12)
    fbank = np.where((k >= lo) & (k < mid), rising,
                     np.where((k >= mid) & (k < hi), falling, 0.0))
    return jnp.asarray(fbank)


def encode_lfbank(spec, prefac=0.97, fs=16000, nfilt=32, lowfreq=0, highfreq=None):
    """Log mel-filterbank energies from a magnitude spectrogram (N, D)."""
    spec = jnp.asarray(spec)
    N, D = spec.shape
    nfft = (D - 1) * 2
    # pre-emphasis response |1 - p e^{-jw}| on D points in [0, pi)
    w = jnp.arange(D) * (jnp.pi / D)
    h = jnp.abs(1.0 - prefac * jnp.exp(-1j * w))
    spec = spec * h
    pspec = jnp.square(spec) / nfft
    fb = get_filterbanks(nfilt, nfft, fs, lowfreq, highfreq)
    feat = jnp.dot(pspec, fb.T, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=pspec.dtype)
    feat = jnp.where(feat == 0, jnp.finfo(jnp.float64).eps, feat)
    return jnp.log(feat)


def _interp_rows(xq, xp, Y):
    """np.interp(xq, xp, row) for each row of Y; xp ascending, edge-clamped."""
    j = jnp.clip(jnp.searchsorted(xp, xq, side="right") - 1, 0, xp.shape[0] - 2)
    x0, x1 = xp[j], xp[j + 1]
    t = jnp.clip((xq - x0) / jnp.where(x1 == x0, 1.0, x1 - x0), 0.0, 1.0)
    return Y[:, j] * (1 - t) + Y[:, j + 1] * t


def encode_mcep(spec, n0=12, fs=16000, lowhz=0, highhz=8000):
    """Mel-warped cepstrum (main.py:324-341)."""
    spec = jnp.asarray(spec)
    D = spec.shape[1]
    Xl = jnp.log(spec)
    lowmel = float(hz2mel(lowhz))
    highmel = float(hz2mel(highhz))
    melpoints = np.linspace(lowmel, highmel, D)
    bins = jnp.asarray(np.floor(((D - 1) * 2 + 1)
                                * np.asarray(mel2hz(melpoints)) / fs))
    Xml = _interp_rows(bins, jnp.arange(D, dtype=spec.dtype), Xl)
    Xc = jnp.fft.irfft(Xml, axis=-1)
    return Xc[:, :n0]


def decode_mcep(cepstrum, fft_size, fs=16000, lowhz=0, highhz=8000):
    """Magnitude spectrum from MCEP (main.py:343-358).

    NB the reference hardcodes fs=16000 at main.py:355; the default here
    preserves that behavior, overridable via ``fs``.
    """
    cepstrum = jnp.asarray(cepstrum)
    n0 = cepstrum.shape[1]
    N = cepstrum.shape[0]
    Yc = jnp.zeros((N, fft_size), cepstrum.dtype)
    Yc = Yc.at[:, :n0].set(cepstrum)
    Yc = Yc.at[:, : -n0:-1].set(cepstrum[:, 1:n0])
    Yl = jnp.fft.rfft(Yc, axis=-1).real
    D = int(fft_size // 2 + 1)
    lowmel = float(hz2mel(lowhz))
    highmel = float(hz2mel(highhz))
    melpoints = np.linspace(lowmel, highmel, D)
    bins = jnp.asarray(np.floor(fft_size * np.asarray(mel2hz(melpoints)) / fs))
    Yl = _interp_rows(jnp.arange(D, dtype=cepstrum.dtype), bins, Yl)
    return jnp.exp(Yl)


def get_context(X, w=5):
    """Stack +/-w frames of context (main.py:360-365)."""
    X = jnp.asarray(X)
    N, D = X.shape
    pad = jnp.concatenate([jnp.tile(X[:1], (w, 1)), X, jnp.tile(X[-1:], (w, 1))])
    idx = jnp.arange(N)[:, None] + jnp.arange(2 * w + 1)[None, :]
    return pad[idx].reshape(N, (2 * w + 1) * D)


def encode_vae(Xc, energy, encoder, decoder, window, n0, batch_size, mean):
    """VC latent round-trip through external encoder/decoder models
    (main.py:367-384).  encoder/decoder are any objects with .predict."""
    Xc = np.asarray(Xc)
    assert Xc.shape[1] == n0 - 1
    Xc = Xc - mean
    Xc = np.asarray(get_context(Xc, w=window))
    Zc = encoder.predict(Xc, batch_size=batch_size)
    Yc = decoder.predict(Zc)
    Yc = Yc[:, window * (n0 - 1):(window + 1) * (n0 - 1)]
    out = np.zeros((Yc.shape[0], n0))
    out[:, 0] = energy
    out[:, 1:n0] = Yc + mean
    return Zc, out
