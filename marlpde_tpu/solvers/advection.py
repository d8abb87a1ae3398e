"""Advection solvers (u_t + nu*u_x = 0, periodic) — Lax scheme + RL stencil actions.

Parity targets:
  * Lax step with Courant alpha = nu*dt/dx          Advection.py:42-43,138-152
    (M@u)_i = (0.5+0.5a)*u_{i-1} + (0.5-0.5a)*u_{i+1}
  * 2-weight stencil actions                        Advection.py:154-200
    global mode (2 scalars):   (M@u)_i = a0*u_{i-1} + (1-a0-a1)*u_i + a1*u_{i+1}
    per-point mode (2/point):  (M@u)_i = (1-a0_i-a1_i)*u_i + a0_i*u_{i+1} + a1_i*u_{i-1}
    NB: the two modes map (a0, a1) to *opposite* neighbors in the reference;
    replicated verbatim.
  * analytical solution sin((x-nu*t-offset)*2*pi/L) Advection.py:289-291
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from marlpde_tpu.core.grids import Grid
from marlpde_tpu.utils.pytree import PyTreeNode


@dataclasses.dataclass(frozen=True, eq=True)
class AdvectionConfig:
    N: int
    L: float = 2.0 * np.pi
    dt: float = 0.001
    nu: float = 0.01    # advection speed

    @property
    def grid(self) -> Grid:
        return Grid(self.N, self.L)

    @property
    def alpha(self) -> float:
        return self.nu * self.dt / self.grid.dx


class AdvectionState(PyTreeNode):
    u: jax.Array
    t: jax.Array
    ioutnum: jax.Array
    nu: jax.Array
    offset: jax.Array


def init(cfg: AdvectionConfig, u0, *, nu=None, offset=0.0) -> AdvectionState:
    u0 = jnp.asarray(u0)
    batch = u0.shape[:-1]
    dtype = u0.dtype
    return AdvectionState(
        u=u0, t=jnp.zeros(batch, dtype), ioutnum=jnp.zeros(batch, jnp.int32),
        nu=jnp.full(batch, cfg.nu if nu is None else nu, dtype),
        offset=jnp.asarray(offset, dtype) * jnp.ones(batch, dtype))


def lax_step(cfg: AdvectionConfig, state: AdvectionState) -> jax.Array:
    """Lax method (Advection.py:138-152).

    NB the reference computes alpha from the ctor nu *before* nunoise resampling
    (Advection.py:43-46); we use the state's live nu, i.e. the intended scheme.
    """
    u = state.u
    alpha = state.nu[..., None] * cfg.dt / cfg.grid.dx
    return (0.5 + 0.5 * alpha) * jnp.roll(u, 1, -1) + (0.5 - 0.5 * alpha) * jnp.roll(u, -1, -1)


def action_step_global(cfg: AdvectionConfig, state: AdvectionState, a0, a1):
    """2-scalar global stencil (Advection.py:160-169): a0 -> sub-diagonal (u_{i-1}),
    a1 -> super-diagonal (u_{i+1}), diag 1-a0-a1."""
    u = state.u
    a0 = jnp.asarray(a0)[..., None]
    a1 = jnp.asarray(a1)[..., None]
    return a0 * jnp.roll(u, 1, -1) + (1.0 - a0 - a1) * u + a1 * jnp.roll(u, -1, -1)


def action_step_pointwise(cfg: AdvectionConfig, state: AdvectionState, a0, a1):
    """Per-point 2-weight stencil (Advection.py:171-194): for row i,
    a0_i -> u_{i+1}, a1_i -> u_{i-1}, diag 1-a0_i-a1_i.  a0, a1: (..., N)."""
    u = state.u
    return (1.0 - a0 - a1) * u + a0 * jnp.roll(u, -1, -1) + a1 * jnp.roll(u, 1, -1)


def advance(cfg: AdvectionConfig, state: AdvectionState, u_new) -> AdvectionState:
    return state.replace(u=u_new, t=state.t + cfg.dt, ioutnum=state.ioutnum + 1)


def step(cfg: AdvectionConfig, state: AdvectionState, actions=None,
         pointwise: bool = True) -> tuple[AdvectionState, dict]:
    if actions is None:
        return advance(cfg, state, lax_step(cfg, state)), {}
    a0, a1 = actions
    if pointwise:
        u_new = action_step_pointwise(cfg, state, a0, a1)
    else:
        u_new = action_step_global(cfg, state, a0, a1)
    return advance(cfg, state, u_new), dict(gradient=u_new)


def analytical_sinus(state: AdvectionState, cfg: AdvectionConfig, t=None) -> jax.Array:
    """sin((x - nu*t - offset)*2*pi/L)   (Advection.py:289-291)."""
    t = state.t if t is None else t
    x = jnp.asarray(cfg.grid.x, state.u.dtype)
    arg = x - (state.nu * t)[..., None] - state.offset[..., None]
    return jnp.sin(arg * 2.0 * np.pi / cfg.L)


def simulate(cfg: AdvectionConfig, state: AdvectionState, nsteps: int):
    def body(s, _):
        s, _aux = step(cfg, s)
        return s, s.u

    final, uu = jax.lax.scan(body, state, None, length=nsteps)
    return final, jnp.concatenate([state.u[None], uu], axis=0)
