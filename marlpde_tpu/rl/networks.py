"""VRACER network: one MLP trunk emitting V(s), policy mean, and policy stddev.

Parity target: the korali function approximator configured by the drivers —
2 hidden Linear(width) + Tanh layers on OneDNN, Adam (run-vracer-burger.py:175-190),
with a single network for value + policy (that is what makes it V-RACER).

sigma is parameterized as softplus(raw) scaled so that raw=0 gives the
driver's "Initial Exploration Noise" (run-vracer-burger.py:158).

The MLPs are plain JAX.  Parameters are the nested dict
``{"params": {"Dense_i": {"kernel": (in, out), "bias": (out,)}}}`` with the
layers numbered in order of application, and kernels are drawn LeCun-normal
(truncated) with zero biases — the layout and initial distributions of a
``flax.linen.Dense`` stack, so parameter trees saved from one load into the
other.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

# Gradient leak of the sigma ceiling: above the cap the BACKWARD pass sees
# this slope instead of zero.  A hard min has exactly zero gradient above the
# cap, so once a transient ratchet drives softplus-sigma past sigma_max
# neither the trust-region KL nor the policy gradient can ever pull it back —
# sigma is frozen at the ceiling for the rest of the run (ADVICE r3).  A
# VALUE leak (round-4 first attempt) is worse: the REFER sigma ratchet simply
# climbs the 5% slope — measured on flagship 910, sigma 0.18 -> 7.7 over 260
# generations, collection destroyed (_result_burger-marl_910/history.json).
# The straight-through form keeps the FORWARD value exactly min(sigma, cap)
# (collection can never see sigma above the cap) while the backward pass uses
# the leaky slope, preserving the downward recovery path.
SIGMA_CAP_LEAK = 0.05


def leaky_sigma_cap(sigma, sigma_max, leak: float = SIGMA_CAP_LEAK):
    """Straight-through sigma ceiling: value = min(sigma, cap); gradient =
    identity below the cap, `leak` above it."""
    over = jnp.maximum(sigma - sigma_max, 0.0)
    hard = jnp.minimum(sigma, sigma_max)
    leaky = hard + leak * over
    # forward evaluates to `hard`; gradient flows through `leaky`
    return leaky + jax.lax.stop_gradient(hard - leaky)


def dense_init(key, fan_in: int, fan_out: int, dtype=jnp.float32,
               zero_kernel: bool = False):
    """One Dense layer: LeCun-normal (truncated) kernel, zero bias."""
    kernel = (jnp.zeros((fan_in, fan_out), dtype) if zero_kernel else
              jax.nn.initializers.lecun_normal()(key, (fan_in, fan_out), dtype))
    return {"kernel": kernel, "bias": jnp.zeros((fan_out,), dtype)}


def dense(layer, x):
    return x @ layer["kernel"] + layer["bias"]


@dataclasses.dataclass(frozen=True)
class VracerNet:
    act_dim: int
    width: int = 128
    n_hidden: int = 2
    init_noise: float = 0.1       # initial sigma (iex)
    sigma_floor: float = 1e-5
    # Policy-mean parameterization.
    #   'absolute':        mu = Dense(h) — korali-style direct output.
    #   'sigma_relative':  mu = Dense_0init(h) * stop_grad(sigma) — the mean
    #     is expressed in units of the exploration stddev (eNAC / natural-
    #     gradient coordinates).  Rationale (measured, runs/ks_916.log +
    #     runs/diffusion_961.log): Adam's per-weight step is scale-free, so
    #     with 'absolute' the policy mean drifts ~lr per update in ABSOLUTE
    #     action units regardless of sigma.  When sigma << that drift scale
    #     (reference KS: iex=1e-3 on a +-5 action range,
    #     run-vracer-ks.py:15,99-101) every replay experience goes far-policy
    #     within one generation, REFER's beta collapses (measured 0.3 ->
    #     5e-4) and learning freezes.  In sigma units the policy-gradient
    #     d logpi / d mu_tilde = (a-mu)/sigma is O(1), Adam's drift becomes
    #     proportional to sigma, and the REFER drift budget is satisfiable at
    #     any iex.  The zero-init also starts mu at exactly 0 (the
    #     uncontrolled baseline) instead of a random O(0.1) field.
    mu_param: str = "absolute"    # 'absolute' | 'sigma_relative'
    # Exploration-sigma ceiling.  korali leaves sigma unbounded; in long
    # spectral-reward runs the policy gradient can inflate sigma without
    # limit (observed: 0.2 -> 5.9 over 1e5 updates, degrading collection
    # while the deterministic policy stays good).  Beyond the action RANGE a
    # clipped-normal is effectively a bound-sampler anyway, so capping there
    # loses nothing.  inf = korali-faithful unbounded (default).
    sigma_max: float = np.inf

    def init(self, key, obs):
        """Parameters for observations shaped like ``obs`` (..., obs_dim).

        Layer order is fixed across mu_param modes (Dense_{n_hidden} = value,
        Dense_{n_hidden+1} = mean head, Dense_{n_hidden+2} = sigma head), so
        checkpoints can never silently cross-load swapped heads."""
        n = self.n_hidden
        sizes = [obs.shape[-1]] + [self.width] * n
        heads = {"value": (n, 1), "mu": (n + 1, self.act_dim),
                 "sigma": (n + 2, self.act_dim)}
        keys = jax.random.split(key, n + 3)
        p = {f"Dense_{i}": dense_init(keys[i], sizes[i], self.width)
             for i in range(n)}
        for name, (i, out) in heads.items():
            zero = name == "sigma" or (name == "mu"
                                       and self.mu_param == "sigma_relative")
            p[f"Dense_{i}"] = dense_init(keys[i], self.width, out,
                                         zero_kernel=zero)
        return {"params": p}

    def apply(self, params, obs):
        """obs (..., obs_dim) -> (V (...,), mu (..., A), sigma (..., A))."""
        p = params["params"]
        n = self.n_hidden
        h = obs
        for i in range(n):
            h = jnp.tanh(dense(p[f"Dense_{i}"], h))
        v = dense(p[f"Dense_{n}"], h)[..., 0]
        mu = dense(p[f"Dense_{n + 1}"], h)
        raw = dense(p[f"Dense_{n + 2}"], h)
        # softplus(0) = log 2, so raw=0 yields sigma = init_noise exactly
        sigma = (jax.nn.softplus(raw) * (self.init_noise / float(np.log(2.0)))
                 + self.sigma_floor)
        if np.isfinite(self.sigma_max):
            # leaky ceiling: exact identity below the cap (a tanh cap would
            # distort sigma everywhere — iex=3 under cap 5 would start at
            # 2.68); above it a small leak keeps a downward gradient path so
            # sigma can re-enter the feasible range (see leaky_sigma_cap)
            sigma = leaky_sigma_cap(sigma, self.sigma_max)
        if self.mu_param == "sigma_relative":
            # mu (the Dense output above) is mu-in-sigma-units; rescale
            mu = mu * jax.lax.stop_gradient(sigma)
        return v, mu, sigma
