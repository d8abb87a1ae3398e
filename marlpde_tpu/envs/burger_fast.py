"""Whole-batch fast path for the spectral-reward Burgers closure env.

`envs/burger_env.py` is the general per-env implementation (vmapped by the
rollout).  This module implements the same episode semantics for the flagship
configuration (ABCN, spectral reward, dforce, no stochastic forcing / closures)
operating on the WHOLE (B, N) batch at once.  The default runs the
macro-step in plain jnp (`abcn_pallas.abcn_macro_step_reference`, which XLA
compiles to cuFFT transforms and fusions); `use_pallas=True` runs the fused
Pallas macro-step kernel (`ops/abcn_pallas.py`, one kernel per macro-step)
on identical math.

Reward parity with burger_env.step (spectral path) is tested in
tests/test_pallas.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from marlpde_tpu.envs import burger_env, features
from marlpde_tpu.ops import abcn_pallas
from marlpde_tpu.utils.pytree import PyTreeNode


class FastEnvState(PyTreeNode):
    u: jax.Array          # (B, N)
    u_prev: jax.Array     # (B, N) previous sub-step field (dudt feature)
    v_re: jax.Array
    v_im: jax.Array
    fn_re: jax.Array
    fn_im: jax.Array
    nu: jax.Array         # (B, 1)
    sidx: jax.Array       # (B,)
    ioutnum: jax.Array    # (B,)
    ek_sum: jax.Array     # (B, N)
    prev_rel_err: jax.Array  # (B,)
    done: jax.Array       # (B,)
    cum_reward: jax.Array  # (B, num_agents)


def reset(cfg: burger_env.BurgerEnvConfig, pool, keys, counts):
    """Batched reset (offset draws vmapped); returns (FastEnvState, obs)."""
    st, obs = jax.vmap(lambda k, c: burger_env.reset(cfg, pool, k, c))(keys, counts)
    s = st.solver
    return FastEnvState(
        u=s.u, u_prev=st.u_prev, v_re=jnp.real(s.v), v_im=jnp.imag(s.v),
        fn_re=jnp.real(s.fn_old), fn_im=jnp.imag(s.fn_old),
        nu=s.nu[:, None], sidx=st.sidx, ioutnum=s.ioutnum,
        ek_sum=st.ek_sum, prev_rel_err=st.prev_rel_err,
        done=st.done, cum_reward=st.cum_reward), obs


def step(cfg: burger_env.BurgerEnvConfig, pool, state: FastEnvState,
         actions: jax.Array, use_pallas: bool = False, tile_b: int = 32,
         interpret: bool = False):
    """Batched macro-step.  actions: (B, num_agents, actions_per_agent).
    ``interpret`` runs the Pallas kernel in the interpreter (CPU tests)."""
    B_, N = state.u.shape
    dtype = state.u.dtype
    lcfg = cfg.les_solver
    dx = lcfg.grid.dx
    g = cfg.grid_size
    basis = jnp.asarray(burger_env.action_basis(cfg), dtype)
    # solver-side matmul: full float32, never TF32 (the forcing integrates
    # over the whole episode)
    action_field = jnp.matmul(actions.reshape(B_, -1), basis,
                              precision=jax.lax.Precision.HIGHEST)  # (B, N)
    af = jnp.fft.fft(action_field, axis=-1)
    af_re, af_im = jnp.real(af), jnp.imag(af)

    fn = abcn_pallas.abcn_macro_step if use_pallas else \
        abcn_pallas.abcn_macro_step_reference
    kw = dict(n_intermediate=cfg.n_intermediate, dt=cfg.dt, dx=float(dx))
    if use_pallas:
        kw.update(tile_b=tile_b, interpret=interpret)
    u, u_prev, v_re, v_im, fn_re, fn_im, ek_delta = fn(
        state.u, state.v_re, state.v_im, state.fn_re, state.fn_im,
        state.nu, af_re, af_im, **kw)

    ioutnum = state.ioutnum + cfg.n_intermediate
    ek_sum = state.ek_sum + ek_delta
    count = (ioutnum + 1).astype(dtype)[:, None]
    sgs_ektt = ek_sum[:, 1: g // 2] / count
    dns_ektt = pool.ek_ktt[state.sidx[:, None], ioutnum[:, None],
                           jnp.arange(1, g // 2)[None, :]]
    rel_err = jnp.mean(((jnp.abs(dns_ektt - sgs_ektt)) / dns_ektt) ** 2, axis=-1)
    reward = (state.prev_rel_err - rel_err)[:, None] * jnp.ones(
        (1, cfg.num_agents), dtype) * cfg.reward_factor

    blown = ~(jnp.isfinite(u).all(axis=-1) & jnp.isfinite(reward).all(axis=-1))
    reward = jnp.where(blown[:, None],
                       jnp.asarray(cfg.truncation_penalty, dtype), reward)
    macro = ioutnum // cfg.n_intermediate
    done = blown | (macro >= cfg.episode_length) | state.done

    was = state.done

    def keep(new, old):
        return jnp.where(was.reshape((-1,) + (1,) * (new.ndim - 1)), old, new)

    new_state = FastEnvState(
        u=keep(u, state.u), u_prev=keep(u_prev, state.u_prev),
        v_re=keep(v_re, state.v_re),
        v_im=keep(v_im, state.v_im), fn_re=keep(fn_re, state.fn_re),
        fn_im=keep(fn_im, state.fn_im), nu=state.nu, sidx=state.sidx,
        ioutnum=keep(ioutnum, state.ioutnum), ek_sum=keep(ek_sum, state.ek_sum),
        prev_rel_err=keep(rel_err, state.prev_rel_err), done=done,
        cum_reward=state.cum_reward + jnp.where(was[:, None], 0.0, reward))
    reward = jnp.where(was[:, None], 0.0, reward)

    v = jax.lax.complex(new_state.v_re, new_state.v_im)
    obs = features.burger_features(cfg.version, cfg.num_agents, new_state.u,
                                   new_state.u_prev, v, cfg.dt, dx)
    obs = jnp.where(jnp.isfinite(obs), obs, 0.0)
    return new_state, obs, reward, done, dict(blown=blown)
