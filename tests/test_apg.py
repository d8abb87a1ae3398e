"""APG: analytic policy gradient through the differentiable rollout.

The on-device upgrade of the reference's gradient-aware RL
(burger_jax_environment.py:50,94 s["State Gradient"] on the korali safe-rl
branch): the return is differentiated through the full scan."""

import jax
import jax.numpy as jnp
import numpy as np

from marlpde_tpu.envs import registry
from marlpde_tpu.rl import apg, vracer
from marlpde_tpu.train import trainer


class TestApg:
    def test_return_is_differentiable_and_improves(self):
        env = registry.make_env("burger-jax", N_dns=64, grid_size=16,
                                num_actions=16, dt=0.01, T=0.2,
                                episode_length=10)
        rl_cfg = trainer.default_rl_config(env, width=32)
        ts, hist = apg.train_apg(
            env, rl_cfg, apg.ApgConfig(iterations=25, batch_size=4, lr=2e-3),
            key=jax.random.key(1), verbose=False)
        first = np.mean(hist["mean_return"][:3])
        last = np.mean(hist["mean_return"][-3:])
        assert np.isfinite(first) and np.isfinite(last)
        # gradient ascent must improve the (negative-MSE) return materially
        assert last > first
        assert (last - first) > 0.2 * abs(first)

    def test_squash_respects_bounds_and_has_gradient(self):
        g = jax.grad(lambda m: jnp.sum(apg.squash(m, -5.0, 5.0)))(
            jnp.asarray([0.0, 4.9, -4.9, 100.0]))
        a = apg.squash(jnp.asarray([-1e3, 0.0, 1e3]), -5.0, 5.0)
        assert np.all(np.asarray(a) >= -5.0) and np.all(np.asarray(a) <= 5.0)
        assert np.asarray(g)[0] > 0.5          # interior: healthy gradient
        assert np.all(np.isfinite(np.asarray(g)))
