"""On-device episode collection: policy-in-the-loop lax.scan over vmapped envs.

This replaces the reference's per-macro-step Python<->C++ ping-pong
(burger_environment.py:140 s.update() blocking on the korali agent): the policy
network is applied inside the scan body, so a whole generation of episodes is
one XLA computation.  The env batch axis is the scaling axis — shard it over a
device mesh (parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp

from marlpde_tpu.rl import vracer


@dataclasses.dataclass(frozen=True)
class Env:
    """Uniform functional env interface over the concrete env modules.

    ``consts`` holds large runtime data (DNS pools) that must flow through jit
    boundaries as an ARGUMENT, never a python closure: closure-captured device
    arrays become compile-time constants, which bloats programs.
    """

    name: str
    cfg: Any
    reset: Callable          # (consts, key, episode_count) -> (state, obs)
    step: Callable           # (consts, state, actions) -> (state, obs, reward, done, info)
    obs_dim: int
    num_agents: int
    act_dim: int             # actions per agent
    episode_length: int
    action_low: float
    action_high: float
    consts: Any = ()         # pytree of runtime constants (e.g. the DNS pool)
    # Whole-batch fast path (envs/burger_fast.py): same episode semantics as
    # (reset, step) but operating on the full (B, ...) batch in one call
    # (plain jnp, or the fused macro-step kernel of ops/abcn_pallas.py) in
    # place of the vmapped per-env step.  When set, collect_episodes rolls out through these and
    # training runs at the benched whole-batch speed.
    batch_reset: Callable | None = None   # (consts, keys, counts) -> (state, obs)
    batch_step: Callable | None = None    # (consts, state, actions) -> (state, obs, reward, done, info)

    def reset0(self, key, episode_count):
        """Convenience (outside jit): reset with self.consts bound."""
        return self.reset(self.consts, key, episode_count)

    def step0(self, state, actions):
        """Convenience (outside jit): step with self.consts bound."""
        return self.step(self.consts, state, actions)


def collect_episodes(env: Env, rl_cfg, ts, key, batch_size: int,
                     episode_base: int | jax.Array = 0, deterministic=False,
                     consts=None, record_fields: bool = False):
    """Roll out `batch_size` envs for a full episode.

    Returns a dict of stacked episode tensors with layout (B, T, na, ...):
    obs, actions, mu, sigma, rewards, mask — ready for replay.add_episodes —
    plus cum_rewards (B, na) and final env states.

    ``consts`` overrides env.consts (pass it through your jit boundary).
    ``record_fields`` additionally records the solved field (B, T, N) and,
    for spectral envs, the cumulative-mean energy spectrum — the contents of
    the reference's save-episode npz (burger_environment.py:207-238:
    sgs_u / sgs_Ektt); replay ignores the extra keys.
    """
    consts = env.consts if consts is None else consts
    k_reset, k_roll = jax.random.split(key)
    reset_keys = jax.random.split(k_reset, batch_size)
    counts = episode_base + jnp.arange(batch_size)
    whole_batch = env.batch_reset is not None and env.batch_step is not None
    if whole_batch:
        state, obs = env.batch_reset(consts, reset_keys, counts)
    else:
        state, obs = jax.vmap(lambda k, c: env.reset(consts, k, c))(reset_keys, counts)

    def macro(carry, k):
        st, ob = carry
        if deterministic:
            a = vracer.act_deterministic(rl_cfg, ts, ob)
            _, mu, sigma = vracer.policy_apply(rl_cfg, ts, ob)
        else:
            a, mu, sigma = vracer.act(rl_cfg, ts, ob, k)
        was_done = st.done
        if whole_batch:
            st2, ob2, rew, done, info = env.batch_step(consts, st, a)
        else:
            st2, ob2, rew, done, info = jax.vmap(
                lambda s, a_: env.step(consts, s, a_))(st, a)
        out = dict(obs=ob, actions=a, mu=mu, sigma=sigma, rewards=rew,
                   mask=jnp.asarray(~was_done, ob.dtype),
                   blown=info["blown"])
        if record_fields:
            u_f = st2.u if hasattr(st2, "u") else st2.solver.u
            out["fields"] = u_f
            if hasattr(st2, "ek_sum"):
                io = (st2.ioutnum if hasattr(st2, "ioutnum")
                      else st2.solver.ioutnum)
                out["ektt"] = st2.ek_sum / (io + 1).astype(u_f.dtype)[..., None]
        return (st2, ob2), out

    roll_keys = jax.random.split(k_roll, env.episode_length)
    (final_state, final_obs), traj = jax.lax.scan(macro, (state, obs), roll_keys)
    # (T, B, ...) -> (B, T, ...)
    traj = jax.tree.map(lambda a: jnp.swapaxes(a, 0, 1), traj)
    # Truncated-vs-Terminal bookkeeping (burger_environment.py:198-204): a
    # numeric blowup ends the episode "Truncated" and korali bootstraps the
    # value target from V(s_T); a normal (time-limit or early-stop) end is
    # "Terminal" with no bootstrap.  `final_obs` is the observation after the
    # last executed step (envs freeze once done, so for truncated episodes it
    # is the observation at truncation time).
    blown = traj.pop("blown")                      # (B, T) bool
    traj["truncated"] = blown.any(axis=1)          # (B,) bool
    traj["final_obs"] = final_obs                  # (B, na, obs_dim)
    return traj, final_state


def zero_action_episode(env: Env, key, batch_size: int = 1, episode_base=0,
                        consts=None):
    """The reference's korali-free smoke loop (tests/burger/loop.py:99-135):
    run a full episode with zero actions; returns (traj dict, final states)."""
    consts = env.consts if consts is None else consts
    reset_keys = jax.random.split(key, batch_size)
    counts = episode_base + jnp.arange(batch_size)
    state, obs = jax.vmap(lambda k, c: env.reset(consts, k, c))(reset_keys, counts)
    zero = jnp.zeros((batch_size, env.num_agents, env.act_dim), obs.dtype)

    def macro(carry, _):
        st, ob = carry
        st2, ob2, rew, done, _info = jax.vmap(
            lambda s, a_: env.step(consts, s, a_))(st, zero)
        return (st2, ob2), dict(obs=ob, rewards=rew, done=done)

    (final_state, _), traj = jax.lax.scan(macro, (state, obs), None,
                                          length=env.episode_length)
    traj = jax.tree.map(lambda a: jnp.swapaxes(a, 0, 1), traj)
    return traj, final_state
