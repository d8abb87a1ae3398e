"""Advection stencil-learning environment.

Parity target: advection_environment_simple.py (bonus dict :31-35, early stop
on cumreward<0) with Advection.py's pointwise 2-weight stencil actions
(:171-194; per agent 2*(N/numAgents) interleaved weights, even index ->
u_{i+1}, odd -> u_{i-1}) and the analytical sinus MSE reward (:238-249).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from marlpde_tpu.core import ic
from marlpde_tpu.envs import features
from marlpde_tpu.solvers import advection
from marlpde_tpu.utils.pytree import PyTreeNode

# advection_environment_simple.py:31-35
BONUS = {128: 5e-2, 64: 5e-2, 32: 5e-2, 16: 1e-1, 8: 1e-1}


@dataclasses.dataclass(frozen=True, eq=True)
class AdvectionEnvConfig:
    """Mirrors run-vracer-advection-simple.py defaults."""

    N: int = 32
    num_agents: int = 1
    L: float = 2.0 * np.pi
    dt: float = 0.01
    nu: float = 0.5
    episode_length: int = 500
    ic_case: str = "sinus"
    noise: float = 0.0
    bonus: float | None = None

    @property
    def solver(self) -> advection.AdvectionConfig:
        return advection.AdvectionConfig(N=self.N, L=self.L, dt=self.dt, nu=self.nu)

    @property
    def survival_bonus(self) -> float:
        return self.bonus if self.bonus is not None else BONUS.get(self.N, 5e-2)

    @property
    def obs_dim(self) -> int:
        return self.N if self.num_agents == 1 else self.N // self.num_agents + 2

    @property
    def actions_per_agent(self) -> int:
        return 2 * self.N // self.num_agents


class AdvectionEnvState(PyTreeNode):
    solver: advection.AdvectionState
    macro_step: jax.Array
    done: jax.Array
    cum_reward: jax.Array


def reset(cfg: AdvectionEnvConfig, key, episode_count=0, dtype=jnp.float32):
    offset = jnp.zeros((), dtype)
    if cfg.noise > 0.0:
        offset = cfg.noise * jax.random.normal(key, dtype=dtype)
    x = jnp.asarray(cfg.solver.grid.x, dtype)
    assert cfg.ic_case == "sinus", "[advection_env] only sinus implemented (Advection.py:104-113)"
    u0 = ic.diffusion_sinus(offset, x, cfg.L)
    st = advection.init(cfg.solver, u0, offset=offset)
    state = AdvectionEnvState(
        solver=st, macro_step=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool), cum_reward=jnp.zeros((), dtype))
    return state, _observe(cfg, state)


def _observe(cfg: AdvectionEnvConfig, state: AdvectionEnvState):
    u = state.solver.u
    if cfg.num_agents == 1:
        return u[..., None, :]
    idx = jnp.asarray(features.halo_indices(cfg.N, cfg.num_agents))
    return u[..., idx]


def step(cfg: AdvectionEnvConfig, state: AdvectionEnvState, actions: jax.Array):
    """actions: (num_agents, 2*N/num_agents), interleaved (a0, a1) per point."""
    dtype = state.solver.u.dtype
    pairs = actions.reshape(actions.shape[:-2] + (cfg.N, 2))
    a0, a1 = pairs[..., 0], pairs[..., 1]
    sol, _aux = advection.step(cfg.solver, state.solver, (a0, a1), pointwise=True)

    truth = advection.analytical_sinus(sol, cfg.solver)
    sq = (truth - sol.u) ** 2
    reward = -features.agent_block_mean(sq, cfg.num_agents) + cfg.survival_bonus

    blown = ~jnp.isfinite(sol.u).all()
    reward = jnp.where(blown, -1.0, reward)

    macro = state.macro_step + 1
    cum = state.cum_reward + jnp.where(state.done, 0.0, reward.mean())
    done = blown | (macro >= cfg.episode_length) | (cum < 0.0) | state.done

    keep = lambda n, o: jax.tree.map(
        lambda a_, b_: jnp.where(jnp.reshape(state.done, (1,) * a_.ndim), b_, a_), n, o)
    sol = keep(sol, state.solver)
    new_state = AdvectionEnvState(
        solver=sol, macro_step=jnp.where(state.done, state.macro_step, macro),
        done=done, cum_reward=jnp.where(state.done, state.cum_reward, cum))
    reward = jnp.where(state.done, jnp.zeros_like(reward), reward)
    obs = _observe(cfg, new_state)
    obs = jnp.where(jnp.isfinite(obs), obs, 0.0)
    return new_state, obs, reward, done, dict(blown=blown)
