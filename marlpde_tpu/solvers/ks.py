"""Kuramoto-Sivashinsky solver: Fourier spectral + ETDRK4 (Kassam-Trefethen).

Equation: u_t + u_xx + u_xxxx + 0.5*(u^2)_x = 0, periodic on [0, L).

Parity targets:
  * linear symbol l = k^2 - k^4 (+ 'coeffs' override)     KS.py:112-124
  * ETDRK4 contour-integral coefficients (MM=62 roots)    KS.py:127-137
  * step with action forcing entering all phi-terms       KS.py:230-267

Design note (half-spectrum state). KS has a linearly *unstable* band
(0 < |k| < 1), and the nonlinearity only acts through real(ifft(v)) — so any
anti-Hermitian roundoff component of a full complex spectrum grows as
exp(t*l) completely unchecked and eventually overflows.  The reference
survives only because scipy.fftpack's real-input FFT is bit-exactly Hermitian;
numpy/XLA FFTs are not, and a full-spectrum port blows up around step ~1600
(observed, seeds 0-4).  We therefore evolve the rfft half-spectrum, which is
Hermitian *by construction* (and halves FFT work).  ``full_spectrum`` rebuilds
the reference's full-v layout for diagnostics/parity.

The phi-coefficients depend only on (N, L, dt, coeffs) and are computed
host-side in float64 numpy once per config (cached), then baked into the
jitted step as constants.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from marlpde_tpu.core.grids import Grid
from marlpde_tpu.utils.pytree import PyTreeNode


@dataclasses.dataclass(frozen=True, eq=True)
class KSConfig:
    N: int
    L: float = 22.0
    dt: float = 0.25
    dforce: bool = True
    coeffs: Optional[tuple] = None   # 5-tuple altering the linear symbol (KS.py:120-124)
    # 'fft' | 'dft': 'dft' expresses rfft/irfft as real matmuls
    # (ops/dft.py rdft/irdft, full float32) instead of jnp.fft.
    fft_impl: str = "fft"

    def _rfft(self, u):
        if self.fft_impl == "dft":
            from marlpde_tpu.core import spectral
            return spectral.rfft_mm(u)
        return jnp.fft.rfft(u, axis=-1)

    def _irfft(self, rv):
        if self.fft_impl == "dft":
            from marlpde_tpu.core import spectral
            return spectral.irfft_mm(rv, self.N)
        return jnp.fft.irfft(rv, self.N, axis=-1)

    @property
    def grid(self) -> Grid:
        return Grid(self.N, self.L)


class KSState(PyTreeNode):
    u: jax.Array        # (..., N) physical field
    rv: jax.Array       # (..., N//2+1) complex rfft half-spectrum
    t: jax.Array
    ioutnum: jax.Array


def full_spectrum(rv, N):
    """Rebuild the reference's full fft layout from the rfft half-spectrum."""
    tail = jnp.conj(rv[..., 1:N - N // 2])[..., ::-1]
    return jnp.concatenate([rv, tail], axis=-1)


def half_spectrum(v, N):
    return v[..., :N // 2 + 1]


@lru_cache(maxsize=16)
def etdrk4_coeffs(cfg: KSConfig):
    """E, E2, Q, f1, f2, f3, g on the half-spectrum — float64, per KS.py:127-137.

    The Nyquist entry keeps the reference's *negative* fftfreq value inside
    g = -0.5j*k (KS.py:137); even powers in l are sign-independent.
    """
    g = cfg.grid
    half = cfg.N // 2 + 1
    k = g.k[:half]                 # note: k[N//2] is negative, as in the reference
    if cfg.coeffs is None:
        l = k**2 - k**4
    else:
        c = cfg.coeffs
        l = (-c[0] * np.ones_like(k) - c[1] * 1j * k + (1 + c[2]) * k**2
             + c[3] * 1j * k**3 - (1 + c[4]) * k**4)
    dt = cfg.dt
    E = np.exp(dt * l)
    E2 = np.exp(dt * l / 2.0)
    MM = 62
    r = np.exp(1j * np.pi * (np.r_[1:MM + 1] - 0.5) / MM)
    LR = dt * np.repeat(np.asarray(l)[:, None], MM, axis=1) + np.repeat(r[None, :], half, axis=0)
    Q = dt * np.real(np.mean((np.exp(LR / 2.0) - 1.0) / LR, 1))
    f1 = dt * np.real(np.mean((-4.0 - LR + np.exp(LR) * (4.0 - 3.0 * LR + LR**2)) / LR**3, 1))
    f2 = dt * np.real(np.mean((2.0 + LR + np.exp(LR) * (-2.0 + LR)) / LR**3, 1))
    f3 = dt * np.real(np.mean((-4.0 - 3.0 * LR - LR**2 + np.exp(LR) * (4.0 - LR)) / LR**3, 1))
    gk = -0.5j * k
    return E, E2, Q, f1, f2, f3, gk


def init(cfg: KSConfig, u0=None, v0=None) -> KSState:
    """v0 may be a full spectrum (reference layout) or an rfft half-spectrum."""
    if v0 is None:
        u0 = jnp.asarray(u0)
        rv = cfg._rfft(u0)
    else:
        v0 = jnp.asarray(v0)
        if v0.shape[-1] == cfg.N:
            rv = half_spectrum(v0, cfg.N)
        else:
            rv = v0
        u0 = cfg._irfft(rv)
    batch = u0.shape[:-1]
    return KSState(u=u0, rv=rv, t=jnp.zeros(batch, u0.dtype),
                   ioutnum=jnp.zeros(batch, jnp.int32))


def step(cfg: KSConfig, state: KSState,
         action_field: Optional[jax.Array] = None) -> tuple[KSState, dict]:
    """One ETDRK4 step (KS.py:230-267).

    ``action_field``: (..., N) physical forcing (actions @ basis).  With
    dforce=False it is scaled by d2udx2 first (KS.py:240-245).
    """
    E, E2, Q, f1, f2, f3, gk = etdrk4_coeffs(cfg)
    cdtype = state.rv.dtype
    rdtype = state.u.dtype
    E = jnp.asarray(E, cdtype); E2 = jnp.asarray(E2, cdtype)
    Q = jnp.asarray(Q, rdtype); f1 = jnp.asarray(f1, rdtype)
    f2 = jnp.asarray(f2, rdtype); f3 = jnp.asarray(f3, rdtype)
    gk = jnp.asarray(gk, cdtype)

    aux = {}
    F = None
    if action_field is not None:
        af = action_field
        if not cfg.dforce:
            dx = cfg.grid.dx
            d2udx2 = (jnp.roll(state.u, 1, -1) - 2.0 * state.u + jnp.roll(state.u, -1, -1)) / dx**2
            af = af * d2udx2
        aux["sgs"] = af
        F = cfg._rfft(af)

    def nl(z):
        uz = cfg._irfft(z)
        return gk * cfg._rfft(uz * uz)

    v = state.rv
    Nv = nl(v)
    a = E2 * v + Q * Nv
    Na = nl(a)
    b = E2 * v + Q * Na
    Nb = nl(b)
    c = E2 * a + Q * (2.0 * Nb - Nv)
    Nc = nl(c)

    if F is not None:
        v_new = E * v + (Nv + F) * f1 + 2.0 * (Na + Nb + 2.0 * F) * f2 + (Nc + F) * f3
    else:
        v_new = E * v + Nv * f1 + 2.0 * (Na + Nb) * f2 + Nc * f3

    new_state = state.replace(
        u=cfg._irfft(v_new), rv=v_new,
        t=state.t + cfg.dt, ioutnum=state.ioutnum + 1)
    return new_state, aux


def simulate(cfg: KSConfig, state: KSState, nsteps: int, action_fields=None,
             correction=None):
    """Advance nsteps via lax.scan; returns (final_state, uu, vv_full) incl. IC frame.

    vv_full is in the reference's full-spectrum layout for diagnostics parity.
    """

    def body(s, af):
        s, _ = step(cfg, s, af)
        if correction is not None:
            rv = s.rv + half_spectrum(jnp.asarray(correction), cfg.N)
            s = s.replace(rv=rv, u=cfg._irfft(rv))
        return s, (s.u, s.rv)

    if action_fields is None:
        final, (uu, rvv) = jax.lax.scan(lambda s, _: body(s, None), state, None, length=nsteps)
    else:
        final, (uu, rvv) = jax.lax.scan(body, state, action_fields)
    uu = jnp.concatenate([state.u[None], uu], axis=0)
    rvv = jnp.concatenate([state.rv[None], rvv], axis=0)
    return final, uu, full_spectrum(rvv, cfg.N)
