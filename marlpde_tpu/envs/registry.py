"""Workload registry: each reference driver becomes a config preset producing a
uniform functional Env (envs/rollout.py).

Driver map (reference -> preset name):
  run-vracer-burger.py            -> 'burger'
  run-vracer-burger-marl.py       -> 'burger-marl'
  run-vracer-burger-fd.py         -> 'burger-fd'
  run-vracer-ks.py                -> 'ks'
  run-vracer-diffusion-simple.py  -> 'diffusion-simple'
  run-vracer-diffusion.py         -> 'diffusion-stencil3'
  run-vracer-diffusion-error.py   -> 'diffusion-error'
  run-vracer-advection-simple.py  -> 'advection-simple'
  run-vracer-laplace.py           -> 'laplace'
  run-vracer-coupled-burger.py    -> 'coupled-burger'
  run-vracer-burger-jax.py        -> 'burger-jax'  (differentiable RK3 scheme;
                                      whole-episode Jacobians in solvers/burger_grad.py)
  run-cmaes-burger.py             -> 'cmaes-burger' (handled by run.py/run_cmaes)
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax.numpy as jnp

from marlpde_tpu.envs import (advection_env, burger_env, diffusion_env, ks_env,
                              laplace_env)
from marlpde_tpu.envs.rollout import Env


def fast_burger_ok(cfg: burger_env.BurgerEnvConfig) -> bool:
    """Does the whole-batch fast path (envs/burger_fast.py) implement this
    config?  Flagship spectral-reward ABCN closure without stochastic forcing
    or eddy-viscosity closures (the fused kernel covers exactly that math)."""
    import numpy as _np
    return (cfg.scheme == "abcn" and cfg.spectral_reward and cfg.dforce
            and cfg.dns_mode == "pool" and not cfg.coupled
            and not (cfg.ssm or cfg.dsm or cfg.forcing or cfg.ssmforce)
            and not cfg.nunoise and _np.isinf(cfg.state_bound))


def make_burger_env(cfg: burger_env.BurgerEnvConfig = None, n_dns: int = 1,
                    pool=None, dtype=jnp.float32, fast: str = "auto",
                    **overrides) -> Env:
    """``fast`` selects the rollout backend for qualifying configs
    (fast_burger_ok): 'auto' attaches the whole-batch jnp path, 'pallas' the
    fused Pallas macro-step kernel (ops/abcn_pallas.py, Triton route; GPU
    only) and raises for a config the fast path does not implement, 'off'
    keeps the general vmapped env.  Training (envs/rollout.py +
    train/trainer.py) then runs at the benched whole-batch speed; parity with
    the general env is tested in tests/test_pallas.py::TestFastEnvParity."""
    if cfg is None:
        cfg = burger_env.BurgerEnvConfig(**overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if pool is None:
        pool = burger_env.make_dns_pool(cfg, n_dns, dtype=dtype)
    name = "burger-fd" if cfg.scheme == "fd" else (
        "burger-marl" if cfg.num_agents > 1 else "burger")
    batch_reset = batch_step = None
    if fast == "pallas" and not fast_burger_ok(cfg):
        raise ValueError("[registry] fast='pallas' needs a config the "
                         "whole-batch fast path implements (fast_burger_ok)")
    if fast != "off" and fast_burger_ok(cfg):
        from marlpde_tpu.envs import burger_fast
        batch_reset = partial(burger_fast.reset, cfg)
        batch_step = partial(burger_fast.step, cfg,
                             use_pallas=(fast == "pallas"))
    return Env(
        name=name, cfg=cfg,
        reset=partial(burger_env.reset, cfg),
        step=partial(burger_env.step, cfg),
        obs_dim=cfg.obs_dim, num_agents=cfg.num_agents,
        act_dim=cfg.actions_per_agent, episode_length=cfg.episode_length,
        action_low=-5.0, action_high=5.0,   # run-vracer-burger.py:156-157
        consts=pool, batch_reset=batch_reset, batch_step=batch_step)


def make_ks_env(cfg: ks_env.KSEnvConfig = None, n_dns: int = 1, pool=None,
                dtype=jnp.float32, **overrides) -> Env:
    if cfg is None:
        cfg = ks_env.KSEnvConfig(**overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if pool is None:
        pool = ks_env.make_dns_pool(cfg, n_dns, dtype=dtype)
    return Env(
        name="ks", cfg=cfg,
        reset=partial(ks_env.reset, cfg),
        step=partial(ks_env.step, cfg),
        obs_dim=cfg.obs_dim, num_agents=cfg.num_agents,
        act_dim=cfg.actions_per_agent, episode_length=cfg.episode_length,
        action_low=-5.0, action_high=5.0,   # run-vracer-ks.py:92-93
        consts=pool)


def make_diffusion_env(cfg: diffusion_env.DiffusionEnvConfig = None,
                       **overrides) -> Env:
    if cfg is None:
        cfg = diffusion_env.DiffusionEnvConfig(**overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    name = {"simple": "diffusion-simple", "error": "diffusion-error",
            "stencil3": "diffusion-stencil3"}[cfg.mode]
    lo, hi = (-0.1, 0.1) if cfg.mode == "error" else (-5.0, 5.0)
    return Env(
        name=name, cfg=cfg,
        reset=lambda consts, key, count: diffusion_env.reset(cfg, key, count),
        step=lambda consts, state, a: diffusion_env.step(cfg, state, a),
        obs_dim=cfg.obs_dim, num_agents=cfg.num_agents,
        act_dim=cfg.actions_per_agent, episode_length=cfg.episode_length,
        action_low=lo, action_high=hi)      # run-vracer-diffusion-simple.py:95-96


def make_advection_env(cfg: advection_env.AdvectionEnvConfig = None,
                       **overrides) -> Env:
    if cfg is None:
        cfg = advection_env.AdvectionEnvConfig(**overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return Env(
        name="advection-simple", cfg=cfg,
        reset=lambda consts, key, count: advection_env.reset(cfg, key, count),
        step=lambda consts, state, a: advection_env.step(cfg, state, a),
        obs_dim=cfg.obs_dim, num_agents=cfg.num_agents,
        act_dim=cfg.actions_per_agent, episode_length=cfg.episode_length,
        action_low=-2.0, action_high=2.0)   # run-vracer-advection-simple.py:95-96


def make_laplace_env(cfg: laplace_env.LaplaceEnvConfig = None, **overrides) -> Env:
    if cfg is None:
        cfg = laplace_env.LaplaceEnvConfig(**overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return Env(
        name="laplace", cfg=cfg,
        reset=lambda consts, key, count: laplace_env.reset(cfg, key, count),
        step=lambda consts, state, a: laplace_env.step(cfg, state, a),
        obs_dim=cfg.obs_dim, num_agents=cfg.num_agents,
        act_dim=cfg.actions_per_agent, episode_length=cfg.episode_length,
        action_low=-3.0, action_high=3.0)   # run-vracer-laplace.py:85-86


def make_burger_lockstep_env(cfg: burger_env.BurgerEnvConfig = None,
                             **overrides) -> Env:
    """Fresh-DNS-per-episode mode (nunoise path); no pool needed."""
    overrides.setdefault("nunoise", True)
    if cfg is None:
        cfg = burger_env.BurgerEnvConfig(dns_mode="lockstep", **overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, dns_mode="lockstep", **overrides)
    return Env(
        name="burger-lockstep", cfg=cfg,
        reset=partial(burger_env.reset_lockstep, cfg),
        step=partial(burger_env.step_lockstep, cfg),
        obs_dim=cfg.obs_dim, num_agents=cfg.num_agents,
        act_dim=cfg.actions_per_agent, episode_length=cfg.episode_length,
        action_low=-5.0, action_high=5.0)


def make_coupled_burger_env(**kw) -> Env:
    env = make_burger_env(coupled=True, spectral_reward=False, **kw)
    # run-vracer-coupled-burger.py:68-69: actions in [-1, 1]
    return dataclasses.replace(env, name="coupled-burger",
                               action_low=-1.0, action_high=1.0)


def make_burger_jax_env(**kw) -> Env:
    """Differentiable-Burgers closure env (run-vracer-burger-jax.py).

    Reference: RK3 stepper with jacfwd Jacobians (Burger_jax.py:42-66), state
    = d2udx2 (Burger_jax.py:499-508, i.e. version 0), actions in [-5, 5]
    (run-vracer-burger-jax.py:91-93).  Here the whole env is differentiable
    under jax.grad; explicit per-step Jacobian parity lives in
    solvers/burger_grad.py.
    """
    env = make_burger_env(scheme="rk3", version=kw.pop("version", 0), **kw)
    return dataclasses.replace(env, name="burger-jax")


MAKERS = {
    "burger": make_burger_env,
    "burger-jax": make_burger_jax_env,
    "burger-lockstep": make_burger_lockstep_env,
    "coupled-burger": make_coupled_burger_env,
    "burger-marl": lambda **kw: make_burger_env(num_agents=kw.pop("num_agents", 32), **kw),
    "burger-fd": lambda **kw: make_burger_env(
        scheme="fd", state_bound=kw.pop("state_bound", 1e6), **kw),
    "ks": make_ks_env,
    "diffusion-simple": make_diffusion_env,
    "diffusion-error": lambda **kw: make_diffusion_env(mode="error", **kw),
    "diffusion-stencil3": lambda **kw: make_diffusion_env(mode="stencil3", **kw),
    "advection-simple": make_advection_env,
    "laplace": make_laplace_env,
}


def make_env(name: str, **overrides) -> Env:
    if name not in MAKERS:
        raise ValueError(f"[registry] unknown env '{name}'; have {sorted(MAKERS)}")
    return MAKERS[name](**overrides)
