"""Minimum-phase reconstruction via the real cepstrum (batched).

The reference rebuilds a minimum-phase impulse response per synthesis pulse /
frame with 3 FFTs in a Python loop (/root/reference/world/synthesis.py:100-116,
synthesisRequiem.py:89-96).  Here the identical cepstral construction is a
batched fixed-shape transform: all pulses/frames go through ONE set of batched
FFTs.
"""
import jax.numpy as jnp



def mirror_full(half):
    """(..., n//2+1) half spectrum -> (..., n) even-symmetric full spectrum.

    Equivalent to np.r_[s, s[-2:0:-1]] per slice.
    """
    return jnp.concatenate([half, half[..., -2:0:-1]], axis=-1)


def minimum_phase_spectrum(amplitude_full):
    """exp(complex cepstrum) spectrum of a minimum-phase system.

    amplitude_full: (..., fft_size) real, strictly positive amplitude spectrum
    (even-symmetric).  Returns the complex spectrum (..., fft_size) whose
    magnitude is ``amplitude_full`` and whose phase is minimum.
    Matches the reference construction: cepstrum = Re FFT(log a / 2); causal
    part = bins [fft/2 .. fft-1] doubled + DC (synthesis.py:106-111).
    """
    fft_size = amplitude_full.shape[-1]
    cep = jnp.fft.fft(jnp.log(amplitude_full) / 2.0).real
    idx = jnp.arange(fft_size)
    sel = (idx >= fft_size // 2)
    complex_cep = jnp.where(sel, cep * 2.0, 0.0)
    complex_cep = complex_cep.at[..., 0].set(cep[..., 0])
    return jnp.exp(jnp.fft.ifft(complex_cep))


def minimum_phase_response(amplitude_full):
    """fftshift(ifft(min-phase spectrum).real): the time response."""
    spec = minimum_phase_spectrum(amplitude_full)
    return jnp.fft.fftshift(jnp.fft.ifft(spec).real, axes=-1)
