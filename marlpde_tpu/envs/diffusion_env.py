"""Diffusion stencil-learning environments.

Parity targets:
  * diffusion_environment_simple.py: per-point (or scalar) stencil action,
    analytical-MSE reward + survival bonus keyed by N (:32-40), early stop when
    cumreward < 0 (:70-71)
  * diffusion_environment_error.py: truncation-error correction on
    DiffusionError (bonus dict :31-35)
  * diffusion_environment.py: 3-weight global stencil; NB the reference's env
    passes 3 actions into Diffusion.step which asserts len==1 — broken against
    the current solver (documented quirk).  We implement the evident intent:
    zero-sum reweighted stencil (M@u)_i = a0*u_{i-1} + a1*u_i + a2*u_{i+1}.

Mode is selected by ``mode`` in {'simple', 'error', 'stencil3'}.
Per-agent observations are halo-extended slices of u (Diffusion.py:284-298).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from marlpde_tpu.core import ic
from marlpde_tpu.envs import features
from marlpde_tpu.solvers import diffusion
from marlpde_tpu.utils.pytree import PyTreeNode

# survival bonus per grid size (diffusion_environment_simple.py:32-40)
SIMPLE_BONUS = {128: 5e-4, 64: 5e-5, 32: 5e-5, 16: 5e-5, 8: 5e-5, 4: 5e-5, 2: 5e-5, 1: 5e-5}
# diffusion_environment_error.py:31-35 keys on numAgents
ERROR_BONUS = {128: 5e-4, 64: 5e-5, 32: 5e-5, 16: 5e-5, 8: 5e-5, 4: 5e-5, 2: 5e-5, 1: 5e-5}


@dataclasses.dataclass(frozen=True, eq=True)
class DiffusionEnvConfig:
    """Mirrors run-vracer-diffusion-simple.py defaults."""

    N: int = 128
    num_agents: int = 1
    L: float = 2.0 * np.pi
    dt: float = 0.01
    nu: float = 0.1
    episode_length: int = 500
    ic_case: str = "sinus"
    noise: float = 0.5            # offset stddev, NOT scaled by L (Diffusion.py:48)
    mode: str = "simple"          # 'simple' | 'error' | 'stencil3'
    bonus: float | None = None    # override; default from the dicts above

    @property
    def t_end(self) -> float:
        return self.dt * self.episode_length

    @property
    def n_intermediate(self) -> int:
        return 1

    @property
    def solver(self) -> diffusion.DiffusionConfig:
        return diffusion.DiffusionConfig(N=self.N, L=self.L, dt=self.dt, nu=self.nu)

    @property
    def survival_bonus(self) -> float:
        if self.bonus is not None:
            return self.bonus
        return SIMPLE_BONUS.get(self.N, 5e-5)

    @property
    def obs_dim(self) -> int:
        # Diffusion.getState: full u (single) or halo slice (Diffusion.py:284-298)
        return self.N if self.num_agents == 1 else self.N // self.num_agents + 2

    @property
    def actions_per_agent(self) -> int:
        if self.mode == "stencil3":
            return 2                      # third weight is -(a0+a1)
        return self.N // self.num_agents  # per-point center weights


class DiffusionEnvState(PyTreeNode):
    solver: diffusion.DiffusionState
    macro_step: jax.Array
    done: jax.Array
    cum_reward: jax.Array     # scalar mean-over-agents, for the early stop


def _ic_field(cfg: DiffusionEnvConfig, offset, dtype):
    x = jnp.asarray(cfg.solver.grid.x, dtype)
    if cfg.ic_case == "sinus":
        return ic.diffusion_sinus(offset, x, cfg.L)
    if cfg.ic_case == "box":
        return ic.diffusion_box(offset, x, cfg.L)
    if cfg.ic_case == "gaussian":
        return ic.diffusion_gaussian(offset, x, cfg.L)
    raise ValueError(f"[diffusion_env] unknown ic {cfg.ic_case}")


def reset(cfg: DiffusionEnvConfig, key, episode_count=0, dtype=jnp.float32):
    offset = jnp.zeros((), dtype)
    if cfg.noise > 0.0:
        offset = cfg.noise * jax.random.normal(key, dtype=dtype)
    u0 = _ic_field(cfg, offset, dtype)
    st = diffusion.init(cfg.solver, u0, offset=offset)
    state = DiffusionEnvState(
        solver=st, macro_step=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool),
        cum_reward=jnp.zeros((), dtype))
    return state, _observe(cfg, state)


def _observe(cfg: DiffusionEnvConfig, state: DiffusionEnvState):
    u = state.solver.u
    if cfg.num_agents == 1:
        return u[..., None, :]
    idx = jnp.asarray(features.halo_indices(cfg.N, cfg.num_agents))
    return u[..., idx]


def step(cfg: DiffusionEnvConfig, state: DiffusionEnvState, actions: jax.Array):
    """actions: (num_agents, actions_per_agent).  Returns
    (state, obs, reward (num_agents,), done, info)."""
    dtype = state.solver.u.dtype
    scfg = cfg.solver

    if cfg.mode == "stencil3":
        a0 = actions.reshape(-1)[0]
        a1 = actions.reshape(-1)[1]
        a2 = -(a0 + a1)
        u = state.solver.u
        mu = a0 * jnp.roll(u, 1, -1) + a1 * u + a2 * jnp.roll(u, -1, -1)
        u_new = u + cfg.dt * state.solver.nu[..., None] * mu / scfg.grid.dx**2
        sol = diffusion.advance(scfg, state.solver, u_new)
    else:
        a = actions.reshape(-1)
        if a.shape[-1] != cfg.N:
            a = jnp.repeat(a, cfg.N // a.shape[-1], axis=-1)
        sol, _aux = diffusion.step(scfg, state.solver, a,
                                   error_mode=(cfg.mode == "error"))

    # analytical MSE reward (Diffusion.py:238-252) + survival bonus
    truth = diffusion.analytical_sinus(sol, scfg)
    sq = (truth - sol.u) ** 2
    reward = -features.agent_block_mean(sq, cfg.num_agents) + cfg.survival_bonus

    blown = ~jnp.isfinite(sol.u).all()
    reward = jnp.where(blown, -1.0, reward)

    macro = state.macro_step + 1
    cum = state.cum_reward + jnp.where(state.done, 0.0, reward.mean())
    # early stop when cumreward < 0 (diffusion_environment_simple.py:70-71)
    done = blown | (macro >= cfg.episode_length) | (cum < 0.0) | state.done

    keep = lambda n, o: jax.tree.map(
        lambda a_, b_: jnp.where(jnp.reshape(state.done, (1,) * a_.ndim), b_, a_), n, o)
    sol = keep(sol, state.solver)
    new_state = DiffusionEnvState(
        solver=sol, macro_step=jnp.where(state.done, state.macro_step, macro),
        done=done, cum_reward=jnp.where(state.done, state.cum_reward, cum))
    reward = jnp.where(state.done, jnp.zeros_like(reward), reward)
    obs = _observe(cfg, new_state)
    obs = jnp.where(jnp.isfinite(obs), obs, 0.0)
    return new_state, obs, reward, done, dict(blown=blown)
