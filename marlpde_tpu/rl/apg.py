"""Analytic policy gradient (APG): backprop through the differentiable env.

Upgrade target: the reference's gradient-aware RL (korali safe-rl branch)
consumes per-step action Jacobians published as ``s["State Gradient"]``
(burger_jax_environment.py:50,94) that Burger_jax accumulates host-side with
an explicit chain rule (Burger_jax.py:334-374).  Here the whole rollout is
one differentiable XLA program, so instead of shipping Jacobians to a host
learner we differentiate the return directly:

    theta <- theta + lr * d/dtheta E[ sum_t r_t(rollout(theta)) ]

The policy network runs inside the ``lax.scan`` over macro-steps; each
macro-step body is wrapped in ``jax.checkpoint`` so BPTT memory stays
O(T_macro) activations instead of O(T_macro * n_intermediate).

Works with any env whose step is differentiable w.r.t. actions — the
'burger-jax' preset (RK3 scheme, envs/registry.py) is the parity workload.
Actions are bounded with a smooth tanh squash (a hard clip would zero the
gradient at the bounds, killing the signal APG depends on).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import optax

from marlpde_tpu.rl import vracer


@dataclasses.dataclass(frozen=True)
class ApgConfig:
    iterations: int = 100
    batch_size: int = 16
    lr: float = 1e-3
    max_grad_norm: float = 1.0


def squash(mu, low, high):
    """Smooth [low, high] bound: center + halfwidth * tanh(mu / halfwidth)."""
    c = 0.5 * (low + high)
    s = 0.5 * (high - low)
    return c + s * jnp.tanh((mu - c) / s)


def episode_return(env, rl_cfg, params, ts, consts, key, episode_base,
                   batch_size):
    """Mean (over batch and agents) undiscounted episode return of the
    deterministic squashed policy, differentiable w.r.t. ``params``."""
    ts = ts.replace(params=params)
    reset_keys = jax.random.split(key, batch_size)
    counts = episode_base + jnp.arange(batch_size)
    state, obs = jax.vmap(lambda k, c: env.reset(consts, k, c))(reset_keys, counts)

    @jax.checkpoint
    def macro(carry, _):
        st, ob = carry
        _, mu, _ = vracer.policy_apply(rl_cfg, ts, ob)
        a = squash(mu, rl_cfg.action_low, rl_cfg.action_high)
        alive = ~st.done
        st2, ob2, rew, done, _ = jax.vmap(
            lambda s, a_: env.step(consts, s, a_))(st, a)
        rew = rew * alive[..., None].astype(rew.dtype)
        return (st2, ob2), rew

    (_, _), rews = jax.lax.scan(macro, (state, obs), None,
                                length=env.episode_length)
    return jnp.mean(jnp.sum(rews, axis=0))


def train_apg(env, rl_cfg: vracer.VracerConfig, cfg: ApgConfig = ApgConfig(),
              key=None, init_ts: Optional[vracer.TrainState] = None,
              verbose: bool = True):
    """Gradient-ascent on the analytic return.  Returns (ts, history)."""
    key = jax.random.key(0) if key is None else key
    k_init, key = jax.random.split(key)
    ts = init_ts if init_ts is not None else vracer.init_train(rl_cfg, k_init)
    opt = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                      optax.adam(cfg.lr))
    opt_state = opt.init(ts.params)

    @jax.jit
    def step(params, opt_state, consts, k, ep_base):
        ret, g = jax.value_and_grad(
            lambda p: -episode_return(env, rl_cfg, p, ts, consts, k,
                                      ep_base, cfg.batch_size))(params)
        updates, opt_state = opt.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, -ret

    params = ts.params
    history = {"iter": [], "mean_return": [], "best_return": []}
    # incumbent-best tracking (CMAES semantics): the objective is the
    # DETERMINISTIC squashed-mean return, so the best-seen iterate is a
    # well-defined optimizer output — BPTT through chaotic rollouts makes
    # the raw iterate sequence noisy (gradient direction decorrelates over
    # long horizons), and returning the incumbent is the standard fix
    best = (-jnp.inf, params)
    for it in range(cfg.iterations):
        key, k = jax.random.split(key)
        new_params, opt_state, ret = step(params, opt_state, env.consts, k,
                                          jnp.asarray(it * cfg.batch_size))
        # ret is the return OF `params` (evaluated before the update)
        if float(ret) > best[0]:
            best = (float(ret), params)
        params = new_params
        history["iter"].append(it)
        history["mean_return"].append(float(ret))
        history["best_return"].append(best[0])
        if verbose and (it % max(1, cfg.iterations // 10) == 0
                        or it == cfg.iterations - 1):
            print(f"[apg] iter {it} return {float(ret):.6f} "
                  f"best {best[0]:.6f}")
    return ts.replace(params=best[1]), history
