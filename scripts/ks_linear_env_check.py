"""Validate the ks_linear_probe gains through the REAL env harness.

ks_linear_probe.py found per-mode gains whose macro-held forcing beats the
uncontrolled baseline in the standalone fp64 rollout.  This script replays
that policy through marlpde_tpu.envs.ks_env itself (reset/step, the exact
reward code the RL runs use) to confirm conventions and robustness before a
device run: actions_t = irfft(gains * rfft(u_t)) — a deterministic linear
state-feedback inside the VRACER policy class (see ks_linear_probe docstring).

Run on CPU (fp64 and fp32 variants).  Prints controlled vs uncontrolled
cumulative rewards from the env's own step() accounting.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from marlpde_tpu.envs import ks_env  # noqa: E402


def episode(cfg, pool, gains=None):
    from functools import partial

    @partial(jax.jit, static_argnums=2)
    def run(pool, gains, controlled):
        st, obs = ks_env.reset(cfg, pool, jax.random.key(0), 0)

        def macro(carry, _):
            st = carry
            if controlled:
                rv = jnp.fft.rfft(st.solver.u)
                a = jnp.clip(jnp.fft.irfft(gains * rv, cfg.grid_size),
                             -5.0, 5.0)
            else:
                a = jnp.zeros(cfg.num_actions, st.solver.u.dtype)
            st, obs, rew, done, _ = ks_env.step(cfg, pool, st, a)
            return st, rew[0]

        _, rews = jax.lax.scan(macro, st, None, length=cfg.episode_length)
        return rews.sum()

    g = jnp.zeros(cfg.grid_size // 2 + 1, pool.uu.dtype) if gains is None \
        else jnp.asarray(gains, pool.uu.dtype)
    return float(run(pool, g, gains is not None))


def main():
    with open("results/ks_linear_probe_r5.json") as f:
        probe = json.load(f)
    gains = np.array(probe["per_mode"]["gains"])
    out = {}
    for dtype, name in ((jnp.float64, "fp64"), (jnp.float32, "fp32")):
        cfg = ks_env.KSEnvConfig()
        pool = ks_env.make_dns_pool(cfg, 1, dtype=dtype)
        base = episode(cfg, pool)
        ctrl = episode(cfg, pool, gains)
        out[name] = dict(uncontrolled=base, controlled=ctrl,
                         beats=bool(ctrl > base))
    print(json.dumps(out, indent=1))
    with open("results/ks_linear_env_check_r5.json", "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
