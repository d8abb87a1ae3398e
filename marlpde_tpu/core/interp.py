"""On-device interpolation of ground-truth trajectories.

The reference interpolates DNS truth with scipy ``interp2d`` — cubic for
Burgers/KS (Burger.py:323, KS.py:223), linear for diffusion/advection
(Diffusion.py:132).  Queries always land on stored time slices (t = n*dt), so
time interpolation reduces to an index; only space needs real interpolation.

On-device replacement: a *periodic* cubic spline on the uniform grid, whose
circulant tridiagonal system (M_{j-1} + 4 M_j + M_{j+1} = 6 d2y_j) is solved in
Fourier space — one FFT per trajectory frame, batched.  This differs from
scipy's non-periodic B-spline only near the domain edges (the periodic variant
is the physically consistent one for these PDEs); parity tests bound the
difference instead of replicating scipy bug-for-bug.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def periodic_spline_m(y):
    """Second-derivative spline coefficients M (same shape as y, last axis = space).

    Solves M_{j-1} + 4*M_j + M_{j+1} = 6*(y_{j-1} - 2*y_j + y_{j+1})/h^2 with
    h=1 grid units (h factored into evaluation), via the circulant eigenvalues
    4 + 2*cos(2*pi*m/N).
    """
    N = y.shape[-1]
    d2 = jnp.roll(y, 1, axis=-1) - 2.0 * y + jnp.roll(y, -1, axis=-1)
    eig = 4.0 + 2.0 * np.cos(2.0 * np.pi * np.arange(N) / N)
    M = jnp.fft.ifft(jnp.fft.fft(6.0 * d2, axis=-1) / eig, axis=-1)
    return jnp.real(M)


def periodic_spline_eval(y, M, xq, L):
    """Evaluate the periodic cubic spline of `y` (with coeffs `M`) at points `xq`.

    y, M: (..., N) values/coefficients on x_j = j*L/N.  xq: (Q,) query points
    (any real; wrapped into [0, L)).  Returns (..., Q).
    """
    N = y.shape[-1]
    h = L / N
    s = (xq % L) / h                     # in grid units
    j = jnp.floor(s).astype(jnp.int32) % N
    t = s - jnp.floor(s)
    jp = (j + 1) % N
    yj, yjp = y[..., j], y[..., jp]
    Mj, Mjp = M[..., j], M[..., jp]
    omt = 1.0 - t
    # grid-unit spline; M carries 1/h^2 implicitly since d2 was unscaled
    return (yj * omt + yjp * t
            + ((omt**3 - omt) * Mj + (t**3 - t) * Mjp) / 6.0)


def periodic_spline_eval_uniform(y, M, offset, L, Q):
    """Fast path of :func:`periodic_spline_eval` for the standard query grid
    x_i = i*L/Q + offset (uniform coarse grid shifted by a per-sample scalar).

    Because the queries are uniformly strided, j_i = (j0 + (N/Q)*i) mod N with
    a SINGLE fractional part t = frac(offset/h) shared by every query — so the
    four per-query gathers of the general path collapse to one contiguous
    dynamic-slice of the (periodically doubled) frame plus static strided
    slices: an XLA gather becomes a sliced copy, without changing semantics —
    identical j/t algebra, tested bitwise-close against the general path.

    y, M: (..., N) frame values/spline coefficients.  offset: SCALAR grid
    shift (batch via vmap — j0 feeds a dynamic_slice start index, which must
    be rank-0).  Returns (..., Q).
    """
    N = y.shape[-1]
    assert N % Q == 0, (N, Q)
    stride = N // Q
    h = L / N
    s0 = (jnp.asarray(offset) % L) / h              # in grid units, [0, N)
    j0 = jnp.floor(s0).astype(jnp.int32) % N
    t = (s0 - jnp.floor(s0))[..., None]
    # doubled frame: indices j0 .. j0 + N cover every wraparound case
    y2 = jnp.concatenate([y, y], axis=-1)
    M2 = jnp.concatenate([M, M], axis=-1)

    def slice_at(a2):
        if a2.ndim == 1:
            return jax.lax.dynamic_slice(a2, (j0,), (N + 1,))
        # batch dims lead; slice only the last axis
        idx = tuple(jnp.zeros((), jnp.int32) for _ in range(a2.ndim - 1)) + (j0,)
        return jax.lax.dynamic_slice(a2, idx, a2.shape[:-1] + (N + 1,))

    ys = slice_at(y2)
    Ms = slice_at(M2)
    yj, yjp = ys[..., 0:N:stride], ys[..., 1:N + 1:stride]
    Mj, Mjp = Ms[..., 0:N:stride], Ms[..., 1:N + 1:stride]
    omt = 1.0 - t
    return (yj * omt + yjp * t
            + ((omt**3 - omt) * Mj + (t**3 - t) * Mjp) / 6.0)


def cubic_interp(y, xq, L):
    """One-shot periodic cubic interpolation of y(..., N) at xq."""
    return periodic_spline_eval(y, periodic_spline_m(y), xq, L)


def linear_interp(y, xq, L):
    """Periodic linear interpolation of y(..., N) at query points xq (Q,).

    Matches interp2d(kind='linear') away from the last cell; the reference's
    non-periodic interpolant clamps in [x_{N-1}, L) whereas this wraps.
    """
    N = y.shape[-1]
    h = L / N
    s = (xq % L) / h
    j = jnp.floor(s).astype(jnp.int32) % N
    t = s - jnp.floor(s)
    jp = (j + 1) % N
    return y[..., j] * (1.0 - t) + y[..., jp] * t


def frame_index(t, dt, nframes):
    """Index of the stored trajectory frame at time t (t is n*dt up to fp error)."""
    return jnp.clip(jnp.round(t / dt).astype(jnp.int32), 0, nframes - 1)


def shifted_query_points(x, shift, L):
    """The reference's shifted-truth query grid (Burger.py:581-583):
    newx = x + shift, wrapped into [0, L]."""
    newx = x + shift
    newx = jnp.where(newx > L, newx - L, newx)
    newx = jnp.where(newx < 0, newx + L, newx)
    return newx
