"""On-device episode replay buffer (REFER storage layer).

korali's replay (run-vracer-burger.py:166-167) holds 20k-100k *experiences*;
V-RACER's value targets are computed along stored episodes, so the on-device
layout stores whole fixed-length episodes:

  obs      (C, T, na, obs_dim)
  actions  (C, T, na, act_dim)
  mu/sigma (C, T, na, act_dim)   behavior-policy params at sample time
  rewards  (C, T, na)
  mask     (C, T)                1 while the episode was live
  final_obs (C, na, obs_dim)     observation after the last executed step
  truncated (C,)                 True if the episode ended by numeric blowup
                                 ("Truncated" in the reference,
                                 burger_environment.py:201 — the learner then
                                 bootstraps value targets from V(final_obs))
  filled   ()                    number of valid episode slots
  cursor   ()                    ring-buffer write head

The korali-style uniform-EXPERIENCE minibatch mode stores its buffer in
replay_flat.FlatReplay instead (per-experience REFER metadata).

Capacity C is in episodes (max_experiences // T).  Insertion overwrites the
oldest episode (korali's replay is FIFO over experiences, same effect).
All ops are jit-safe (static shapes, dynamic_update_slice writes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from marlpde_tpu.utils.pytree import PyTreeNode


class Replay(PyTreeNode):
    obs: jax.Array
    actions: jax.Array
    mu: jax.Array
    sigma: jax.Array
    rewards: jax.Array
    mask: jax.Array
    final_obs: jax.Array
    truncated: jax.Array
    filled: jax.Array     # int32
    cursor: jax.Array     # int32

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]


def init(capacity: int, T: int, na: int, obs_dim: int, act_dim: int,
         dtype=jnp.float32) -> Replay:
    return Replay(
        obs=jnp.zeros((capacity, T, na, obs_dim), dtype),
        actions=jnp.zeros((capacity, T, na, act_dim), dtype),
        mu=jnp.zeros((capacity, T, na, act_dim), dtype),
        sigma=jnp.ones((capacity, T, na, act_dim), dtype),
        rewards=jnp.zeros((capacity, T, na), dtype),
        mask=jnp.zeros((capacity, T), dtype),
        final_obs=jnp.zeros((capacity, na, obs_dim), dtype),
        truncated=jnp.zeros((capacity,), bool),
        filled=jnp.zeros((), jnp.int32),
        cursor=jnp.zeros((), jnp.int32))


def add_episodes(rep: Replay, batch: dict) -> Replay:
    """Insert a batch of B episodes (leading axis B, time axis T)."""
    B = batch["obs"].shape[0]
    C = rep.capacity
    idx = (rep.cursor + jnp.arange(B)) % C

    def put(buf, new):
        return buf.at[idx].set(new.astype(buf.dtype))

    return rep.replace(
        obs=put(rep.obs, batch["obs"]),
        actions=put(rep.actions, batch["actions"]),
        mu=put(rep.mu, batch["mu"]),
        sigma=put(rep.sigma, batch["sigma"]),
        rewards=put(rep.rewards, batch["rewards"]),
        mask=put(rep.mask, batch["mask"]),
        final_obs=put(rep.final_obs, batch["final_obs"]),
        truncated=rep.truncated.at[idx].set(batch["truncated"]),
        filled=jnp.minimum(rep.filled + B, C),
        cursor=(rep.cursor + B) % C)


def sample_episodes(rep: Replay, key, n: int) -> dict:
    """Uniformly sample n episode slots among the filled ones."""
    idx = jax.random.randint(key, (n,), 0, jnp.maximum(rep.filled, 1))
    return dict(obs=rep.obs[idx], actions=rep.actions[idx], mu=rep.mu[idx],
                sigma=rep.sigma[idx], rewards=rep.rewards[idx],
                mask=rep.mask[idx], final_obs=rep.final_obs[idx],
                truncated=rep.truncated[idx])


def num_experiences(rep: Replay) -> jax.Array:
    return rep.filled * rep.obs.shape[1]
