"""Pallas kernel (Triton route): fused Burgers-ABCN macro-step for batched LES
envs.

One kernel invocation advances a (TB, N) row tile of environments through ALL
n_intermediate ABCN sub-steps (Burger.py:482-489) while accumulating the
per-env energy-spectrum sum the spectral reward needs
(burger_environment.py:172-176).  Each program (one thread block) keeps its
tile's fields in registers for the whole chain and reads the two N x N DFT
matrices once, so device memory is touched once per macro-step instead of
once per sub-step, and the ~40 small transform and elementwise launches of
the plain path (`abcn_macro_step_reference`) become one.

Real-arithmetic layout: v = v_re + i*v_im, k1 = i*k so
  Fn = k1 * DFT(q)  =>  Fn_re = -k * DFT_im(q),  Fn_im = k * DFT_re(q)
ABCN with real C = 0.5*k^2*nu*dt applies independently to re/im parts.

Precision: every in-kernel dot passes ``precision=lax.Precision.HIGHEST``,
which the Triton lowering maps to ``input_precision=IEEE`` — full float32
products, never TF32.  The transforms feed a 5000-sub-step integration, and
TF32's ~3 decimal digits would drift the trajectory.

Tiling: rows are padded in the wrapper to a multiple of the power-of-two row
tile ``tile_b`` (Triton blocks must be powers of two; its dots need >= 16
rows); the grid runs B_pad / tile_b independent programs.

Shapes (per tile): u (TB, N); v_re/v_im/fn_re/fn_im (TB, N); nu (TB, 1);
action forcing spectrum af_re/af_im (TB, N) held fixed over sub-steps.
Outputs: updated state + ek_sum (TB, N) accumulated over the sub-steps.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from marlpde_tpu.ops.dft import _dft_mats

_HI = jax.lax.Precision.HIGHEST


def _dot(a, b):
    return jnp.dot(a, b, precision=_HI, preferred_element_type=jnp.float32)


def _kernel(n_intermediate, dt, dx, u_ref, vre_ref, vim_ref, fre_ref, fim_ref,
            nu_ref, afre_ref, afim_ref, C_ref, S_ref, k_ref,
            u_out, uprev_out, vre_out, vim_out, fre_out, fim_out, ek_out):
    u = u_ref[...]
    v_re = vre_ref[...]
    v_im = vim_ref[...]
    fn_re = fre_ref[...]
    fn_im = fim_ref[...]
    nu = nu_ref[...]
    af_re = afre_ref[...]
    af_im = afim_ref[...]
    C = C_ref[...]
    S = S_ref[...]
    k = k_ref[...]
    N = u.shape[-1]
    ek = jnp.zeros_like(u)
    Cc = 0.5 * (k * k) * nu * dt          # (TB, N) via broadcast
    inv = 1.0 / (1.0 + Cc)

    def body(_, carry):
        u, u_prev, v_re, v_im, fn_re, fn_im, ek = carry
        u_prev = u                      # previous SUB-step field (dudt feature)
        q = 0.5 * u * u
        d_re = _dot(q, C)
        d_im = _dot(q, S)
        new_fn_re = -k * d_im
        new_fn_im = k * d_re
        num_re = (1.0 - Cc) * v_re - 0.5 * dt * (3.0 * new_fn_re - fn_re) + dt * af_re
        num_im = (1.0 - Cc) * v_im - 0.5 * dt * (3.0 * new_fn_im - fn_im) + dt * af_im
        v_re = num_re * inv
        v_im = num_im * inv
        # u = real(ifft(v)) = (v_re @ C + v_im @ S)/N   (idft real part)
        u = (_dot(v_re, C) + _dot(v_im, S)) / N
        ek = ek + 0.5 * (v_re * v_re + v_im * v_im) / N * dx
        return (u, u_prev, v_re, v_im, new_fn_re, new_fn_im, ek)

    u, u_prev, v_re, v_im, fn_re, fn_im, ek = jax.lax.fori_loop(
        0, n_intermediate, body, (u, u, v_re, v_im, fn_re, fn_im, ek))

    u_out[...] = u
    uprev_out[...] = u_prev
    vre_out[...] = v_re
    vim_out[...] = v_im
    fre_out[...] = fn_re
    fim_out[...] = fn_im
    ek_out[...] = ek


@functools.partial(jax.jit, static_argnames=(
    "n_intermediate", "dt", "dx", "tile_b", "num_warps", "interpret"))
def abcn_macro_step(u, v_re, v_im, fn_re, fn_im, nu, af_re, af_im,
                    *, n_intermediate: int, dt: float, dx: float,
                    tile_b: int = 32, num_warps: int = 4,
                    interpret: bool = False):
    """Fused macro-step over a batch of envs.

    u, v_*, fn_*: (B, N) float32; nu: (B, 1); af_*: (B, N) fixed action
    forcing spectrum.  Returns (u, u_prev, v_re, v_im, fn_re, fn_im,
    ek_sum_delta) with u_prev the second-to-last sub-step field (the env's
    dudt feature, Burger.py:616-621).  B may be any size: rows are padded to
    a multiple of ``tile_b`` (a power of two >= 16) and the padding sliced
    off.  ``interpret=True`` runs the kernel in the Pallas interpreter
    (CPU tests).
    """
    if tile_b < 16 or tile_b & (tile_b - 1):
        raise ValueError(f"tile_b={tile_b}: Triton blocks need a power of "
                         f"two of at least 16 rows")
    B, N = u.shape
    Cm, Sm = _dft_mats(N, "float32")
    k = np.fft.fftfreq(N, (dx * N) / (2 * np.pi * N)).astype(np.float32)

    pad = (-B) % tile_b
    rows = [u, v_re, v_im, fn_re, fn_im, nu, af_re, af_im]
    if pad:
        # zero rows stay finite through the step (nu = 0 gives Cc = 0)
        rows = [jnp.pad(a, ((0, pad), (0, 0))) for a in rows]
    Bp = B + pad

    bs = pl.BlockSpec((tile_b, N), lambda i: (i, 0))
    const = lambda r, c: pl.BlockSpec((r, c), lambda i: (0, 0))
    outs = pl.pallas_call(
        functools.partial(_kernel, n_intermediate, dt, dx),
        grid=(Bp // tile_b,),
        in_specs=[bs, bs, bs, bs, bs,
                  pl.BlockSpec((tile_b, 1), lambda i: (i, 0)),
                  bs, bs,
                  const(N, N), const(N, N), const(1, N)],
        out_specs=[bs] * 7,
        out_shape=[jax.ShapeDtypeStruct((Bp, N), jnp.float32)] * 7,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name="abcn_macro_step",
    )(*rows, jnp.asarray(Cm), jnp.asarray(Sm), jnp.asarray(k)[None, :])
    return tuple(o[:B] for o in outs)


def abcn_macro_step_reference(u, v_re, v_im, fn_re, fn_im, nu, af_re, af_im,
                              *, n_intermediate, dt, dx):
    """Pure-jnp oracle with identical math, for kernel validation."""
    N = u.shape[-1]
    k = jnp.asarray(np.fft.fftfreq(N, (dx * N) / (2 * np.pi * N)), u.dtype)
    Cc = 0.5 * (k * k) * nu * dt
    inv = 1.0 / (1.0 + Cc)
    ek = jnp.zeros_like(u)
    u_prev = u
    for _ in range(n_intermediate):
        u_prev = u
        q = 0.5 * u * u
        d = jnp.fft.fft(q, axis=-1)
        new_fn_re = -k * jnp.imag(d)
        new_fn_im = k * jnp.real(d)
        v_re = ((1.0 - Cc) * v_re - 0.5 * dt * (3.0 * new_fn_re - fn_re) + dt * af_re) * inv
        v_im = ((1.0 - Cc) * v_im - 0.5 * dt * (3.0 * new_fn_im - fn_im) + dt * af_im) * inv
        fn_re, fn_im = new_fn_re, new_fn_im
        u = jnp.real(jnp.fft.ifft(v_re + 1j * v_im, axis=-1))
        ek = ek + 0.5 * (v_re**2 + v_im**2) / N * dx
    return u, u_prev, v_re, v_im, fn_re, fn_im, ek
