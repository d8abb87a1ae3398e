"""Spectral utilities: energy diagnostics, restriction, filters, phase shifts.

Behavior-parity targets (reference file:line):
  * energy spectrum  Ek_kt = 0.5*Re(conj(v)*v)/N * dx       (Burger.py:562)
  * cumulative-mean spectrum Ek_ktt                          (Burger.py:555)
  * DNS->LES spectral restriction with g/N rescale           (burger_environment.py:110-112)
  * phase-shift offset  v * exp(1j*2*pi*offset*k)            (burger_environment.py:110)
  * sharp spectral box filter |k| > cut -> 0                 (Burger.py:677-705, ddp/helpers.py:6-12)

All functions are pure, jittable, and batched over arbitrary leading axes.
The fft axis is always the last one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def fft(u):
    return jnp.fft.fft(u, axis=-1)


def ifft(v):
    return jnp.fft.ifft(v, axis=-1)


def irfft_real(v):
    """real(ifft(v)) without assuming conjugate symmetry (matches np.real(ifft(v)))."""
    return jnp.real(jnp.fft.ifft(v, axis=-1))


def fft_mm(u):
    """DFT of a real field via full-float32 matmul (small N; see ops/dft.py)."""
    from marlpde_tpu.ops import dft as _dft
    re, im = _dft.dft(u)
    return jax.lax.complex(re, im)


def fft_mm_complex(v):
    """DFT of a complex field via matmul."""
    from marlpde_tpu.ops import dft as _dft
    re, im = _dft.dft(jnp.real(v), jnp.imag(v))
    return jax.lax.complex(re, im)


def irfft_real_mm(v):
    """real(ifft(v)) via matmul for a general complex spectrum."""
    from marlpde_tpu.ops import dft as _dft
    return _dft.idft_real(jnp.real(v), jnp.imag(v))


def rfft_mm(u):
    """np.fft.rfft via full-float32 matmul (see ops/dft.py)."""
    from marlpde_tpu.ops import dft as _dft
    re, im = _dft.rdft(u)
    return jax.lax.complex(re, im)


def irfft_mm(rv, N: int):
    """np.fft.irfft (Hermitian half-spectrum -> real) via matmul."""
    from marlpde_tpu.ops import dft as _dft
    return _dft.irdft(jnp.real(rv), jnp.imag(rv), N)


def energy_spectrum(v, dx):
    """Kinetic energy per wavenumber: 0.5*Re(conj(v)*v)/N * dx.   [Burger.py:562]"""
    N = v.shape[-1]
    return 0.5 * jnp.real(jnp.conj(v) * v) / N * dx


def cumulative_mean(a, axis=0):
    """Time-cumulative average along `axis`: out[t] = mean(a[:t+1]).  [Burger.py:555]"""
    n = a.shape[axis]
    counts_shape = [1] * a.ndim
    counts_shape[axis] = n
    counts = jnp.arange(1, n + 1, dtype=a.dtype).reshape(counts_shape)
    return jnp.cumsum(a, axis=axis) / counts


def restrict_modes(v, g):
    """Spectral DNS->LES restriction: keep the g lowest modes, rescale by g/N.

    v0 = concat(v[:(g+1)//2], v[-(g-1)//2:]) * g/N    [burger_environment.py:111]

    NB: in the reference, ``-(g-1)//2`` floors a negative numerator, so the tail
    slice has ``g//2`` elements (16 for g=32), making lo+hi == g.
    """
    N = v.shape[-1]
    lo = (g + 1) // 2
    hi = g // 2
    out = jnp.concatenate([v[..., :lo], v[..., N - hi:]], axis=-1)
    return out * (g / N)


def phase_shift(v, offset, k):
    """Apply the reference's random-offset phase shift: v*exp(1j*2*pi*offset*k).

    [burger_environment.py:110].  NB the reference multiplies by 2*pi even
    though k is already in radians-per-length; replicated verbatim.
    """
    return v * jnp.exp(1j * 2.0 * np.pi * offset * k)


def sharp_filter(v, k, kcut):
    """Sharp spectral filter: zero modes with |k| > kcut (in-place in reference).

    [Burger.py:678: hidx = np.abs(k) > nURG//2; v[hidx] = 0]
    """
    return jnp.where(jnp.abs(k) > kcut, 0.0, v)


def box_filter_bar(u, n_les):
    """Spectral box (sharp cutoff) filter onto the same grid, as in ddp/helpers.py:6-12.

    Keeps modes |k_index| <= n_les//2 on the original grid (no decimation).
    """
    N = u.shape[-1]
    v = fft(u)
    kidx = np.abs(np.fft.fftfreq(N, 1.0 / N))
    keep = kidx <= n_les // 2
    return irfft_real(v * jnp.asarray(keep, dtype=v.real.dtype))


def resolved_energy(v, dx, half):
    """Lower half-spectrum energies used as state features (Burger.py:653-654)."""
    return energy_spectrum(v, dx)[..., :half]
