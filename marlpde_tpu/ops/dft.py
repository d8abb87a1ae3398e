"""Small-transform DFTs as real matmuls, the alternative to jnp.fft for
batched tiny transforms.

The closure environments run thousands of independent N=16..256 transforms per
sub-step.  Expressing the DFT as two real (B, N) @ (N, N) matmuls lets XLA
fuse the surrounding elementwise algebra into one GEMM-shaped program.  FLOP
cost 2N^2 vs 5N log N only hurts for N >~ 512, where the batched envs never
operate (the DNS at 512-1024 is simulated once per pool, not per step).

Every matmul runs at ``Precision.HIGHEST``: on the GPU a float32 matmul
otherwise runs in TF32 (~3 decimal digits), and these transforms feed
thousands of integration sub-steps.

Matrices are cached per (N, dtype).  Convention matches numpy: X_k = sum_j
x_j exp(-2*pi*i*j*k/N); inverse includes the 1/N factor.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


def _mm(a, b):
    return jnp.matmul(a, jnp.asarray(b), precision=jax.lax.Precision.HIGHEST)


@lru_cache(maxsize=32)
def _dft_mats(N: int, dtype_str: str):
    j, k = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    ang = -2.0 * np.pi * j * k / N
    dtype = np.dtype(dtype_str)
    return (np.cos(ang).astype(dtype), np.sin(ang).astype(dtype))


def dft(x_re, x_im=None):
    """Forward DFT of the last axis; returns (re, im).  x_im=None means real input."""
    N = x_re.shape[-1]
    C, S = _dft_mats(N, str(x_re.dtype))
    if x_im is None:
        return _mm(x_re, C), _mm(x_re, S)
    return _mm(x_re, C) - _mm(x_im, S), _mm(x_re, S) + _mm(x_im, C)


def idft(v_re, v_im):
    """Inverse DFT (with 1/N); returns (re, im)."""
    N = v_re.shape[-1]
    C, S = _dft_mats(N, str(v_re.dtype))
    re = (_mm(v_re, C) + _mm(v_im, S)) / N  # cos is symmetric; conj flips sin
    im = (-_mm(v_re, S) + _mm(v_im, C)) / N
    return re, im


def idft_real(v_re, v_im):
    """real(ifft(v)) for a general (possibly non-Hermitian) spectrum."""
    return idft(v_re, v_im)[0]


@lru_cache(maxsize=32)
def _rdft_mats(N: int, dtype_str: str):
    half = N // 2 + 1
    j = np.arange(N)[:, None]
    k = np.arange(half)[None, :]
    ang = -2.0 * np.pi * j * k / N
    dtype = np.dtype(dtype_str)
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)   # (N, half)


def rdft(x):
    """rfft of the last axis (real input); returns (re, im), shape (..., N//2+1).

    Matmul form of np.fft.rfft."""
    N = x.shape[-1]
    C, S = _rdft_mats(N, str(x.dtype))
    return _mm(x, C), _mm(x, S)


@lru_cache(maxsize=32)
def _irdft_mats(N: int, dtype_str: str):
    # u_j = (1/N)[v_0 + (-1)^j v_{N/2} + sum_{k=1}^{N/2-1} 2*Re(v_k e^{2pi i jk/N})]
    # (Hermitian reconstruction; Nyquist/DC weight 1, middle modes weight 2)
    half = N // 2 + 1
    k = np.arange(half)[:, None]
    j = np.arange(N)[None, :]
    ang = 2.0 * np.pi * j * k / N
    w = np.full((half, 1), 2.0)
    w[0, 0] = 1.0
    if N % 2 == 0:
        w[-1, 0] = 1.0
    dtype = np.dtype(dtype_str)
    return ((w * np.cos(ang) / N).astype(dtype),
            (-w * np.sin(ang) / N).astype(dtype))                 # (half, N)


def irdft(v_re, v_im, N: int):
    """irfft: Hermitian half-spectrum (..., N//2+1) -> real field (..., N)."""
    A, B = _irdft_mats(N, str(v_re.dtype))
    return _mm(v_re, A) + _mm(v_im, B)
