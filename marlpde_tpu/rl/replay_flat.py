"""Flat per-EXPERIENCE replay ring with korali's REFER metadata.

This is the storage layer for the korali-faithful uniform-experience
minibatch mode (``VracerConfig.minibatch_mode="experience"``).  korali's
replay (run-vracer-burger.py:162-167, run-vracer-diffusion-simple.py:100-105)
is a FIFO over individual experiences — Start Size 20k-32k, Maximum Size
1e5-2^20 — and each experience carries persistent, lazily-refreshed metadata
that the REFER machinery reads:

  * ``sv``   stored state value V(s), refreshed whenever the experience is
             sampled in a minibatch,
  * ``rho``  stored importance weight pi_cur/pi_behavior, refreshed on
             sampling; fresh experiences are on-policy (rho=1),
  * ``off``  persistent off-policy flag (rho outside [1/c, c] at the last
             refresh) — the REPLAY-WIDE mean of this flag is the off-policy
             fraction REFER's beta annealing tracks (NOT the minibatch
             fraction: korali counts over the whole buffer),
  * ``vtg``  stored retrace (V-trace) value, recomputed for the WHOLE episode
             of every sampled experience by the backward recursion
             vtg_t = V_t + min(1,rho_t) * (r_t + gamma*vtg_{t+1} - V_t)
             (korali Agent::updateExperienceMetadata semantics).

Reward rescaling follows korali exactly: rewards are divided by
sqrt(mean(r^2)) over the CURRENT replay contents (second moment, no mean
subtraction — ``reward_scale``), so a near-constant survival-bonus reward
(diffusion_environment_simple.py:32-40) maps to ~1 instead of being blown up
by a tiny variance.

Layout: one experience ring of capacity E (padded episodes from
collect_episodes are compacted at insertion — only live steps are stored, so
early-terminating workloads get korali's true capacity), plus an episode ring
of capacity Eep holding what is only needed once per episode: the final
observation, the Terminal/Truncated flag (burger_environment.py:198-204), and
the truncated-state bootstrap value V(s_T).  Episode begin/end are stored per
experience as GLOBAL experience ids, immune to episode-ring wraparound.

Eviction is experience-FIFO (ring overwrite).  The oldest episode's head can
be overwritten while its tail remains — a documented deviation from korali's
whole-episode eviction; the surviving tail stays fully usable (its retrace
refresh window simply stops at the eviction horizon).

All ops are jit-safe: static shapes, scatter with mode='drop' for the
variable-length compaction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from marlpde_tpu.utils.pytree import PyTreeNode


class FlatReplay(PyTreeNode):
    # experience ring (capacity E)
    obs: jax.Array        # (E, na, obs_dim)
    actions: jax.Array    # (E, na, act_dim)
    mu: jax.Array         # (E, na, act_dim)   behavior-policy params
    sigma: jax.Array      # (E, na, act_dim)
    rewards: jax.Array    # (E, na)            raw (unscaled) rewards
    sv: jax.Array         # (E, na)            stored V(s), lazily refreshed
    vtg: jax.Array        # (E, na)            stored retrace value (scaled units)
    rho: jax.Array        # (E, na)            stored importance weight
    off: jax.Array        # (E, na) bool       persistent off-policy flag
    ep_first: jax.Array   # (E,) int32         global id of episode's first exp
    ep_last: jax.Array    # (E,) int32         global id of episode's last exp
    ep_idx: jax.Array     # (E,) int32         global episode id
    # episode ring (capacity Eep)
    fin_obs: jax.Array    # (Eep, na, obs_dim) obs after the last executed step
    truncated_ep: jax.Array  # (Eep,) bool     numeric-blowup end ("Truncated")
    boot: jax.Array       # (Eep, na)          V(s_T) bootstrap, 0 for terminal
    # counters (global, monotone)
    cursor: jax.Array     # () int32 total experiences ever written
    n_episodes: jax.Array  # () int32 total episodes ever written

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]

    @property
    def ep_capacity(self) -> int:
        return self.fin_obs.shape[0]

    @property
    def live(self) -> jax.Array:
        return jnp.minimum(self.cursor, self.capacity)


def init_flat(capacity: int, ep_capacity: int, na: int, obs_dim: int,
              act_dim: int, dtype=jnp.float32) -> FlatReplay:
    E, Eep = int(capacity), int(ep_capacity)
    return FlatReplay(
        obs=jnp.zeros((E, na, obs_dim), dtype),
        actions=jnp.zeros((E, na, act_dim), dtype),
        mu=jnp.zeros((E, na, act_dim), dtype),
        sigma=jnp.ones((E, na, act_dim), dtype),
        rewards=jnp.zeros((E, na), dtype),
        sv=jnp.zeros((E, na), dtype),
        vtg=jnp.zeros((E, na), dtype),
        rho=jnp.ones((E, na), dtype),
        off=jnp.zeros((E, na), bool),
        ep_first=jnp.zeros((E,), jnp.int32),
        ep_last=jnp.full((E,), -1, jnp.int32),
        ep_idx=jnp.zeros((E,), jnp.int32),
        fin_obs=jnp.zeros((Eep, na, obs_dim), dtype),
        truncated_ep=jnp.zeros((Eep,), bool),
        boot=jnp.zeros((Eep, na), dtype),
        cursor=jnp.zeros((), jnp.int32),
        n_episodes=jnp.zeros((), jnp.int32))


def _live_mask(rep: FlatReplay):
    return jnp.arange(rep.capacity) < rep.live          # (E,)


def reward_scale_sums(rep: FlatReplay, reward_floor=-jnp.inf, extra=None,
                      extra_mask=None):
    """(sum r^2, count) over the live buffer — the psum-able pieces of the
    korali Reward Rescaling sigma.  Device-sharded replays psum these across
    shards before the sqrt so every device sees the GLOBAL scale."""
    # blowup rewards (at/below the raw floor, e.g. the reference's -inf,
    # burger_environment.py:200) are EXCLUDED from the statistic: one -1e4 in
    # 1e5 ordinary ~1e-2 rewards would inflate sigma ~3000x and crush the
    # real learning signal to zero (observed rew_scale 0.01 -> 571 on
    # flagship 907).  They still train, bounded by scaled_reward_floor.
    m = (_live_mask(rep)[:, None] & (rep.rewards > reward_floor)).astype(
        rep.rewards.dtype)
    r = jnp.where(m > 0, rep.rewards, 0.0)
    s = jnp.sum(m * r * r)
    n = jnp.sum(m)
    if extra is not None:
        me = (jnp.broadcast_to(extra_mask[..., None], extra.shape) > 0) & (
            extra > reward_floor)
        me = me.astype(r.dtype)
        re = jnp.where(me > 0, extra, 0.0)
        s = s + jnp.sum(me * re * re)
        n = n + jnp.sum(me)
    return s, n


def scale_from_sums(s, n):
    return jnp.sqrt(jnp.maximum(s / jnp.maximum(n, 1.0), 1e-18))


def reward_scale(rep: FlatReplay, reward_floor=-jnp.inf, extra=None,
                 extra_mask=None):
    """korali Reward Rescaling sigma: sqrt(mean r^2 + eps) over the CURRENT
    replay (second moment, no centering).  ``extra``/``extra_mask`` fold a
    fresh (not yet inserted) episode batch into the statistic — korali adds
    the episode's rewards to its running sum-of-squares before computing the
    new episode's retrace values."""
    return scale_from_sums(*reward_scale_sums(rep, reward_floor, extra,
                                              extra_mask))


def off_policy_sums(rep: FlatReplay):
    """(n_off, n_live_experiences) — psum-able pieces of the replay-wide
    off-policy fraction for device-sharded replays."""
    m = _live_mask(rep)[:, None]
    n_off = jnp.sum(jnp.where(m, rep.off, False))
    n = rep.live * rep.off.shape[1]
    return n_off, n


def off_policy_fraction(rep: FlatReplay):
    """REFER's replay-wide off-policy fraction: mean of the persistent per-
    experience flags over the live buffer (korali's
    _experienceReplayOffPolicyRatio — counted over the replay, not the
    minibatch)."""
    n_off, n = off_policy_sums(rep)
    return n_off.astype(jnp.float32) / jnp.maximum(n, 1).astype(jnp.float32)


def num_experiences(rep: FlatReplay) -> jax.Array:
    return rep.cursor


def add_episodes(rep: FlatReplay, batch: dict, sv, vtg, boot) -> FlatReplay:
    """Compact a padded episode batch (from collect_episodes) into the ring.

    batch: obs/actions/mu/sigma (B,T,na,.), rewards (B,T,na), mask (B,T),
    final_obs (B,na,obs_dim), truncated (B,).  ``sv``/``vtg`` (B,T,na) are the
    insert-time state values and retrace values (on-policy: rho=1), ``boot``
    (B,na) the truncated-state bootstrap (zero for terminal episodes) — korali
    computes all three when an episode enters the buffer.
    Only live (mask==1) steps are written; dead padding is dropped.
    """
    E = rep.capacity
    mask = batch["mask"]
    B, T = mask.shape
    valid = mask > 0
    lengths = valid.sum(axis=1).astype(jnp.int32)              # (B,)
    offs = jnp.cumsum(lengths) - lengths                        # exclusive
    # global experience id of each (b, t) row; rows are packed per episode
    g_row = rep.cursor + offs[:, None] + jnp.cumsum(valid, axis=1) - 1
    # an insert larger than the ring keeps only its newest E rows: two rows
    # of one scatter must never share a slot (which duplicate wins is
    # unspecified on the GPU, and could differ between the buffers)
    keep = valid & (g_row >= rep.cursor + lengths.sum() - E)
    slot = jnp.where(keep, g_row % E, E).reshape(-1)            # E = dropped

    ep_gid = rep.n_episodes + jnp.arange(B, dtype=jnp.int32)    # (B,)
    first_g = rep.cursor + offs
    last_g = first_g + lengths - 1

    def put(buf, rows):
        r = rows.reshape((B * T,) + buf.shape[1:]).astype(buf.dtype)
        return buf.at[slot].set(r, mode="drop")

    es = ep_gid % rep.ep_capacity
    bcast = lambda v: jnp.broadcast_to(v[:, None], (B, T))
    return rep.replace(
        obs=put(rep.obs, batch["obs"]),
        actions=put(rep.actions, batch["actions"]),
        mu=put(rep.mu, batch["mu"]),
        sigma=put(rep.sigma, batch["sigma"]),
        rewards=put(rep.rewards, batch["rewards"]),
        sv=put(rep.sv, sv),
        vtg=put(rep.vtg, vtg),
        rho=put(rep.rho, jnp.ones_like(sv)),
        off=put(rep.off, jnp.zeros(sv.shape, bool)),
        ep_first=put(rep.ep_first, bcast(first_g)),
        ep_last=put(rep.ep_last, bcast(last_g)),
        ep_idx=put(rep.ep_idx, bcast(ep_gid)),
        fin_obs=rep.fin_obs.at[es].set(
            batch["final_obs"].astype(rep.fin_obs.dtype)),
        truncated_ep=rep.truncated_ep.at[es].set(batch["truncated"]),
        boot=rep.boot.at[es].set(boot.astype(rep.boot.dtype)),
        cursor=rep.cursor + lengths.sum(),
        n_episodes=rep.n_episodes + B)


def sample_ids(rep: FlatReplay, key, n: int):
    """n uniform draws over the live global-id range [cursor-live, cursor)
    (korali generateMiniBatch: uniform over the buffer, with replacement)."""
    u = jax.random.randint(key, (n,), 0, jnp.maximum(rep.live, 1))
    return rep.cursor - rep.live + u                            # (n,) global


def gather(rep: FlatReplay, g):
    """Rows + episode metadata for global experience ids g (n,)."""
    s = g % rep.capacity
    es = rep.ep_idx[s] % rep.ep_capacity
    return dict(obs=rep.obs[s], actions=rep.actions[s], mu=rep.mu[s],
                sigma=rep.sigma[s], rewards=rep.rewards[s],
                ep_first=rep.ep_first[s], ep_last=rep.ep_last[s],
                fin_obs=rep.fin_obs[es], truncated=rep.truncated_ep[es],
                ep_slot=es, g=g, slot=s)


def refresh_metadata(rep: FlatReplay, g, V_new, rho_new, off_new,
                     boot_new) -> FlatReplay:
    """Scatter refreshed per-experience metadata at sampled ids g (korali
    updateExperienceMetadata part 1): stored state value, importance weight,
    persistent off-policy flag; plus the episode-ring bootstrap values."""
    s = g % rep.capacity
    es = rep.ep_idx[s] % rep.ep_capacity
    return rep.replace(
        sv=rep.sv.at[s].set(V_new.astype(rep.sv.dtype)),
        rho=rep.rho.at[s].set(rho_new.astype(rep.rho.dtype)),
        off=rep.off.at[s].set(off_new),
        boot=rep.boot.at[es].set(boot_new.astype(rep.boot.dtype)))


def refresh_retrace(rep: FlatReplay, g, T_window: int, gamma, scale,
                    reward_floor=-jnp.inf,
                    scaled_floor=-jnp.inf) -> tuple[FlatReplay, jax.Array]:
    """korali updateExperienceMetadata part 2: recompute the stored retrace
    values of the WHOLE episode of every sampled experience by the backward
    recursion vtg_t = V_t + min(1,rho_t)*(r_t + gamma*vtg_{t+1} - V_t),
    seeded with the truncated-state bootstrap V(s_T) (or 0 for terminal
    episodes), using the just-refreshed sv/rho at sampled points and the
    stored (stale) values elsewhere — exactly korali's lazy scheme.

    Returns (rep with refreshed vtg, vtg_next (n, na)) where vtg_next is the
    refreshed retrace value of g+1 (or the bootstrap at episode end) — the
    successor value korali's VRACER loss consumes.

    T_window must be >= the longest episode (use cfg.episode_length).
    """
    E = rep.capacity
    n = g.shape[0]
    s = g % E
    ep_first, ep_last = rep.ep_first[s], rep.ep_last[s]         # (n,)
    es = rep.ep_idx[s] % rep.ep_capacity
    boot0 = jnp.where(rep.truncated_ep[es][:, None], rep.boot[es], 0.0)

    # window of global ids descending from the episode end
    w = ep_last[:, None] - jnp.arange(T_window, dtype=jnp.int32)[None, :]
    horizon = rep.cursor - rep.live
    valid = (w >= ep_first[:, None]) & (w >= horizon)           # (n, Tw)
    ws = jnp.where(valid, w % E, E)                             # E = dropped

    sv_w = rep.sv.at[ws].get(mode="fill", fill_value=0.0)       # (n, Tw, na)
    r_w = jnp.maximum(jnp.maximum(
        rep.rewards.at[ws].get(mode="fill", fill_value=0.0),
        reward_floor) / scale, scaled_floor)
    rho_w = rep.rho.at[ws].get(mode="fill", fill_value=1.0)
    rho_bar = jnp.minimum(rho_w, 1.0)

    # The recursion vt_k = sv_k + rb_k*(r_k + gamma*vt_{k-1} - sv_k) is the
    # affine map vt_k = a_k*vt_{k-1} + b_k (invalid window slots pass the
    # carry through: a=1, b=0), so the whole window resolves as a log-depth
    # prefix composition instead of a T-step sequential scan of 500 tiny
    # dependent steps, which bounded each update's latency.
    val = valid[:, :, None]
    a = jnp.where(val, gamma * rho_bar, 1.0)                    # (n, Tw, na)
    b = jnp.where(val, sv_w * (1.0 - rho_bar) + rho_bar * r_w, 0.0)

    def compose(x, y):
        # prefix c_k = f_k . f_{k-1} . ... . f_0 ; fn(x, y) = y . x
        ax, bx = x
        ay, by = y
        return ay * ax, ay * bx + by

    A, B = jax.lax.associative_scan(compose, (a, b), axis=1)
    new_vtg = A * boot0[:, None, :] + B                         # (n, Tw, na)

    vtg_buf = rep.vtg.at[ws.reshape(-1)].set(
        new_vtg.reshape(-1, rep.vtg.shape[1]).astype(rep.vtg.dtype),
        mode="drop")

    # successor value for the sampled experience: refreshed vtg at g+1, or
    # the bootstrap at episode end.  Window index of g+1 is d-1 with
    # d = ep_last - g (the recursion emitted vts[k] for window slot k).
    d = ep_last - g                                             # (n,) >= 0
    at_end = d == 0
    idx = jnp.maximum(d - 1, 0)
    vtg_next = jnp.where(at_end[:, None],
                         boot0, jnp.take_along_axis(
                             new_vtg, idx[:, None, None], axis=1)[:, 0, :])
    return rep.replace(vtg=vtg_buf), vtg_next
