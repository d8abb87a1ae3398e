"""Heat-equation solvers (u_t = nu*u_xx, periodic) with RL stencil actions.

Parity targets:
  * explicit Euler central FD                       Diffusion.py:152-160
  * implicit Euler — the reference builds a dense periodic tridiagonal matrix
    and calls np.linalg.solve (Diffusion.py:137-149); the matrix is circulant,
    so we solve it exactly in Fourier space (eigenvalues 1+2c-2c*cos(2*pi*m/N))
    — mathematically identical, O(N log N), batched
  * stencil actions: center weight a_i, neighbors -a_i/2,
    u += dt*nu*(M@u)/dx^2                           Diffusion.py:164-206
  * truncation-error actions: center -2+a_i, neighbors 1-a_i/2
                                                    DiffusionError.py:160-198
  * analytical sinus decay u0*exp(-(2*pi/L)^2*nu*t) Diffusion.py:301-303
  * Lax advection and its 2-weight stencil actions live in advection.py
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from marlpde_tpu.core.grids import Grid
from marlpde_tpu.utils.pytree import PyTreeNode


@dataclasses.dataclass(frozen=True, eq=True)
class DiffusionConfig:
    N: int
    L: float = 2.0 * np.pi
    dt: float = 0.001
    nu: float = 0.01
    implicit: bool = False

    @property
    def grid(self) -> Grid:
        return Grid(self.N, self.L)

    @property
    def cfl_violated(self) -> bool:
        # Diffusion.py:53: warn if 2*nu*dt >= dx^2 (explicit only)
        return (not self.implicit) and 2.0 * self.nu * self.dt >= self.grid.dx**2


class DiffusionState(PyTreeNode):
    u: jax.Array
    t: jax.Array
    ioutnum: jax.Array
    nu: jax.Array
    offset: jax.Array
    u0: jax.Array      # kept for the analytical sinus solution


def init(cfg: DiffusionConfig, u0, *, nu=None, offset=0.0) -> DiffusionState:
    u0 = jnp.asarray(u0)
    batch = u0.shape[:-1]
    dtype = u0.dtype
    return DiffusionState(
        u=u0, t=jnp.zeros(batch, dtype), ioutnum=jnp.zeros(batch, jnp.int32),
        nu=jnp.full(batch, cfg.nu if nu is None else nu, dtype),
        offset=jnp.asarray(offset, dtype) * jnp.ones(batch, dtype), u0=u0)


def fd_step(cfg: DiffusionConfig, state: DiffusionState) -> jax.Array:
    """Uncontrolled update (Diffusion.py:137-162)."""
    u, nu = state.u, state.nu[..., None]
    dx2 = cfg.grid.dx**2
    if cfg.implicit:
        c = cfg.dt * nu / dx2
        eig = 1.0 + 2.0 * c - 2.0 * c * jnp.cos(
            2.0 * np.pi * jnp.arange(cfg.N, dtype=u.dtype) / cfg.N)
        return jnp.real(jnp.fft.ifft(jnp.fft.fft(u, axis=-1) / eig, axis=-1))
    d2udx2 = (jnp.roll(u, 1, -1) - 2.0 * u + jnp.roll(u, -1, -1)) / dx2
    return u + cfg.dt * nu * d2udx2


def action_step(cfg: DiffusionConfig, state: DiffusionState, a: jax.Array,
                error_mode: bool = False) -> tuple[jax.Array, dict]:
    """Stencil-action update from the per-point center weights ``a`` (..., N).

    Normal mode (Diffusion.py:176-206):  (M@u)_i = a_i*u_i - a_i/2*(u_{i-1}+u_{i+1}),
    then u += dt*nu*(M@u)/dx^2.  A single global scalar action is the a_i = const case.
    error_mode (DiffusionError.py:160-198): (M@u)_i = (-2+a_i)*u_i + (1-a_i/2)*(u_{i-1}+u_{i+1}).
    """
    u = state.u
    um, up = jnp.roll(u, 1, -1), jnp.roll(u, -1, -1)
    if error_mode:
        mu = (-2.0 + a) * u + (1.0 - a / 2.0) * (um + up)
        diag = -2.0 + a
    else:
        mu = a * u - a / 2.0 * (um + up)
        diag = a
    u_new = u + cfg.dt * state.nu[..., None] * mu / cfg.grid.dx**2
    return u_new, dict(gradient=mu, action_diag=diag)


def advance(cfg: DiffusionConfig, state: DiffusionState, u_new: jax.Array) -> DiffusionState:
    return state.replace(u=u_new, t=state.t + cfg.dt, ioutnum=state.ioutnum + 1)


def step(cfg: DiffusionConfig, state: DiffusionState, a=None,
         error_mode: bool = False) -> tuple[DiffusionState, dict]:
    if a is None:
        return advance(cfg, state, fd_step(cfg, state)), {}
    u_new, aux = action_step(cfg, state, a, error_mode)
    return advance(cfg, state, u_new), aux


def analytical_sinus(state: DiffusionState, cfg: DiffusionConfig, t=None) -> jax.Array:
    """u0*exp(-(2*pi/L)^2*nu*t)   (Diffusion.py:301-303)."""
    t = state.t if t is None else t
    decay = jnp.exp(-((2.0 * np.pi / cfg.L) ** 2) * state.nu * t)
    return state.u0 * decay[..., None]


def simulate(cfg: DiffusionConfig, state: DiffusionState, nsteps: int):
    """Uncontrolled rollout; returns (final_state, uu) with IC frame included."""

    def body(s, _):
        s, _aux = step(cfg, s)
        return s, s.u

    final, uu = jax.lax.scan(body, state, None, length=nsteps)
    return final, jnp.concatenate([state.u[None], uu], axis=0)
