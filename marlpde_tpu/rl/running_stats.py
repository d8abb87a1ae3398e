"""Running mean/std normalizers: korali's State Rescaling + Reward Rescaling
(run-vracer-burger.py:170-171), as Welford-style batch-merged accumulators."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from marlpde_tpu.utils.pytree import PyTreeNode


class RunningStats(PyTreeNode):
    mean: jax.Array
    m2: jax.Array
    count: jax.Array

    @property
    def std(self):
        var = self.m2 / jnp.maximum(self.count - 1.0, 1.0)
        return jnp.sqrt(jnp.maximum(var, 1e-12))


def init(shape, dtype=jnp.float32) -> RunningStats:
    return RunningStats(mean=jnp.zeros(shape, dtype), m2=jnp.ones(shape, dtype),
                        count=jnp.ones((), dtype))


def update(rs: RunningStats, batch, weights=None) -> RunningStats:
    """Merge a batch (leading axes collapsed) into the accumulator."""
    flat = batch.reshape((-1,) + rs.mean.shape)
    if weights is not None:
        w = weights.reshape(-1)
        wc = w[:, None] if rs.mean.ndim else w
        # zero excluded rows BEFORE any arithmetic: with huge/inf excluded
        # values, x*0 or (x-mean)^2*0 would be inf*0 = NaN
        flat = jnp.where(wc > 0, flat, 0.0)
        n_b = jnp.maximum(w.sum(), 1e-8)
        mean_b = (flat * wc).sum(0) / n_b
        diff2 = jnp.where(wc > 0, (flat - mean_b) ** 2, 0.0)
        m2_b = (diff2 * wc).sum(0)
    else:
        n_b = jnp.asarray(flat.shape[0], flat.dtype)
        mean_b = flat.mean(0)
        m2_b = ((flat - mean_b) ** 2).sum(0)
    delta = mean_b - rs.mean
    tot = rs.count + n_b
    new_mean = rs.mean + delta * n_b / tot
    new_m2 = rs.m2 + m2_b + delta**2 * rs.count * n_b / tot
    return RunningStats(mean=new_mean, m2=new_m2, count=tot)


def normalize(rs: RunningStats, x):
    return (x - rs.mean) / rs.std


def scale(rs: RunningStats, x):
    """Reward rescaling: divide by running std, no centering (korali behavior)."""
    return x / rs.std


def second_moment(rs: RunningStats):
    """sqrt(E[x^2]) of everything ever folded in — the uncentered scale the
    flat-replay reward rescaling uses, but over the CUMULATIVE run history
    instead of the live buffer (monotone count => slowly drifting scale)."""
    ex2 = rs.m2 / jnp.maximum(rs.count, 1.0) + rs.mean**2
    return jnp.sqrt(jnp.maximum(ex2, 1e-18))
