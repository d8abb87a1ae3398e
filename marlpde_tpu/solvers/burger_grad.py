"""Differentiable Burgers: action->state Jacobians for gradient-aware RL.

Parity target: Burger_jax.py — jitted RK3 kernels with jacfwd Jacobians
w.r.t. (actions, u) (:23-66) and the chain-rule accumulation
``gradient = dudu @ gradient + duda`` across sub-steps (:337-374), published
to korali as s["State Gradient"] (burger_jax_environment.py:50,94).

In this framework the whole env is differentiable, so the generic path is
jax.jacfwd over the rolled-out step; this module provides (a) that generic
jacobian, and (b) the reference's explicit accumulated-Jacobian recurrence for
step-by-step parity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from marlpde_tpu.core import spectral
from marlpde_tpu.solvers import burger


def rk3_kernel(cfg: burger.BurgerConfig):
    """(actions_field, u, v) -> (u', v'): one RK3 sub-step with direct forcing
    (Burger_jax.py:42-64).  `basis` is applied by the caller."""
    k1 = jnp.asarray(cfg.grid.k1)
    k2 = jnp.asarray(cfg.grid.k2)
    dt, nu = cfg.dt, cfg.nu

    def kern(action_field, u, v):
        F = spectral.fft(action_field)

        def rhs(u_, v_):
            return -0.5 * k1 * spectral.fft(u_ * u_) + nu * k2 * v_ + F

        v1 = v + dt * rhs(u, v)
        u1 = spectral.irfft_real(v1)
        v2 = 0.75 * v + 0.25 * v1 + 0.25 * dt * rhs(u1, v1)
        u2 = spectral.irfft_real(v2)
        v3 = v / 3.0 + 2.0 / 3.0 * v2 + 2.0 / 3.0 * dt * rhs(u2, v2)
        return spectral.irfft_real(v3), v3

    return kern


def step_with_grad(cfg: burger.BurgerConfig, basis, u, v, grad, actions,
                   n_intermediate: int):
    """Advance n_intermediate RK3 sub-steps accumulating d u / d actions.

    Replicates Burger_jax.step (:337-374): per sub-step,
      (duda, dudu) = jacfwd(kernel, argnums=(0,1)) evaluated in real space,
      gradient <- dudu @ gradient + duda.
    grad: (N, M) accumulated Jacobian.  Returns (u, v, grad).
    """
    kern = rk3_kernel(cfg)
    B = jnp.asarray(basis, u.dtype)

    def one(carry, _):
        u_, v_, g_ = carry
        field = actions @ B

        def u_out(a_field, uu):
            un, _ = kern(a_field, uu, spectral.fft(uu))
            return un

        duda_field, dudu = jax.jacfwd(u_out, argnums=(0, 1))(field, u_)
        duda = duda_field @ B.T                      # chain through the basis
        un, vn = kern(field, u_, v_)
        gn = dudu @ g_ + duda
        return (un, vn, gn), None

    (u, v, grad), _ = jax.lax.scan(one, (u, v, grad), None, length=n_intermediate)
    return u, v, grad


def episode_jacobian(cfg: burger.BurgerConfig, basis, u0, actions_seq,
                     n_intermediate: int):
    """Full-episode action Jacobians via one jacfwd over the rollout — the
    on-device generalization (no per-step host accumulation)."""
    B = jnp.asarray(basis, u0.dtype)

    def roll(acts):
        def macro(u, a):
            field = a @ B

            def sub(uu, _):
                un, _vn = rk3_kernel(cfg)(field, uu, spectral.fft(uu))
                return un, None

            u, _ = jax.lax.scan(sub, u, None, length=n_intermediate)
            return u, u

        _, us = jax.lax.scan(macro, u0, acts)
        return us

    return jax.jacfwd(roll)(actions_seq)
