"""Laplace pseudo-time RL environment.

Parity target: laplace_environment.py (direct residual reward, fixed-length
episodes, no early stop) with Laplace.py (num_agents 3-weight stencils,
Dirichlet BC row; run-vracer-laplace.py defaults: N=32 agents, dt=0.01,
episodeLength=100, actions in [-3, 3]).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from marlpde_tpu.core import ic
from marlpde_tpu.solvers import laplace
from marlpde_tpu.utils.pytree import PyTreeNode


@dataclasses.dataclass(frozen=True, eq=True)
class LaplaceEnvConfig:
    num_agents: int = 32
    L: float = 2.0 * np.pi
    dt: float = 0.01
    episode_length: int = 100
    ic_case: str = "one"
    sforce: str = "zero"
    noise: float = 0.0

    @property
    def solver(self) -> laplace.LaplaceConfig:
        return laplace.LaplaceConfig(num_agents=self.num_agents, L=self.L, dt=self.dt)

    @property
    def obs_dim(self) -> int:
        return 4                      # [u_{i-1}, u_i, u_{i+1}, f_i] (Laplace.py:166)

    @property
    def actions_per_agent(self) -> int:
        return 3


class LaplaceEnvState(PyTreeNode):
    solver: laplace.LaplaceState
    macro_step: jax.Array
    done: jax.Array
    cum_reward: jax.Array


def reset(cfg: LaplaceEnvConfig, key, episode_count=0, dtype=jnp.float32):
    k_off, k_force = jax.random.split(key)
    offset = jnp.zeros((), dtype)
    if cfg.noise > 0.0:
        offset = cfg.L * cfg.noise * jax.random.normal(k_off, dtype=dtype)
    x = jnp.asarray(cfg.solver.grid.x, dtype)
    u0 = ic.laplace_ic(cfg.ic_case, x)
    force = ic.laplace_force(cfg.sforce, k_force, offset, x, cfg.L)
    st = laplace.init(cfg.solver, u0, force)
    state = LaplaceEnvState(
        solver=st, macro_step=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool), cum_reward=jnp.zeros((), dtype))
    return state, laplace.get_state(cfg.solver, st)


def step(cfg: LaplaceEnvConfig, state: LaplaceEnvState, actions: jax.Array):
    """actions: (num_agents, 3)."""
    sol, _aux = laplace.step(cfg.solver, state.solver, actions)
    reward = laplace.direct_reward(cfg.solver, sol)

    blown = ~jnp.isfinite(sol.u).all()
    reward = jnp.where(blown, -1e3, reward)

    macro = state.macro_step + 1
    done = blown | (macro >= cfg.episode_length) | state.done

    keep = lambda n, o: jax.tree.map(
        lambda a_, b_: jnp.where(jnp.reshape(state.done, (1,) * a_.ndim), b_, a_), n, o)
    sol = keep(sol, state.solver)
    new_state = LaplaceEnvState(
        solver=sol, macro_step=jnp.where(state.done, state.macro_step, macro),
        done=done,
        cum_reward=state.cum_reward + jnp.where(state.done, 0.0, reward.mean()))
    reward = jnp.where(state.done, jnp.zeros_like(reward), reward)
    obs = laplace.get_state(cfg.solver, sol)
    obs = jnp.where(jnp.isfinite(obs), obs, 0.0)
    return new_state, obs, reward, done, dict(blown=blown)
