"""V-RACER: off-policy actor-critic with REFER (Remember-and-Forget Experience
Replay), in pure JAX — the in-framework replacement for the korali C++ engine.

Algorithm per Novati & Koumoutsakos, "Remember and Forget for Experience
Replay" (ICML 2019), with the configuration surface the reference drivers use
(run-vracer-burger.py:127-195):
  * single network for V(s), policy mean and stddev (networks.VracerNet)
  * Clipped Normal policy, state & reward rescaling
  * V-trace value targets along stored episodes (one-sample clipped IS)
  * policy gradient rho_t * A_t * grad log pi for near-policy samples
    (1/c < rho < c), KL(behavior || pi) attraction for far-policy samples
  * adaptive beta mixing toward the target off-policy fraction D=0.1
  * cutoff annealing c = c0 / (1 + anneal_rate * n_updates)

Episode-end semantics follow the reference (burger_environment.py:198-204):
time-limit / early-stop ends are "Terminal" (no value bootstrap), numeric
blowups are "Truncated" and bootstrap V-trace tails from V(s_T).

The korali-faithful path is ``minibatch_mode="experience"`` (the run.py
default): uniform-experience minibatches over the flat REFER replay
(replay_flat) with stored lazily-refreshed metadata, whole-episode retrace
refresh per update, the replay-wide off-policy fraction driving beta at the
annealed learning rate, second-moment reward rescaling over the live buffer,
and state-rescaling coefficients frozen once updates begin.

Deviations from korali (each deliberate, documented at its definition):
  * ``minibatch_mode="episode"``: whole-episode minibatches with exact
    V-trace tails under the current network.
  * ``trust_region="jeffreys"`` (default): symmetrized far-policy KL — the
    paper's forward KL is log-cheap for sigma growth and quadratic for
    shrinkage, so exploration noise ratchets up unboundedly (measured,
    distributions.kl_jeffreys).  "forward" restores the paper term.
  * ``sigma_max`` defaults to half the action range in run.py — a clipped
    normal with sigma >= (ub-lb)/2 is already ~uniform-over-box, so the cap
    removes no realizable behavior, only the ratchet's tail.
  * blowup containment: the reference envs emit reward = -inf on numeric
    blowup; those rewards are floored (reward_floor), EXCLUDED from the
    reward-rescaling statistic (replay_flat.reward_scale), and bounded in
    scaled units (scaled_reward_floor) so one blowup cannot crush the
    learning signal or detonate the value loss.
  * optimizer is optax.adam with the driver's learning rate.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax

from marlpde_tpu.rl import distributions as D
from marlpde_tpu.rl import networks, running_stats
from marlpde_tpu.utils.pytree import PyTreeNode


@dataclasses.dataclass(frozen=True, eq=True)
class VracerConfig:
    obs_dim: int
    act_dim: int
    num_agents: int = 1
    episode_length: int = 500
    # korali solver settings (run-vracer-burger.py:127-171)
    gamma: float = 1.0
    lr: float = 1e-4
    width: int = 128
    n_hidden: int = 2
    mini_batch_episodes: int = 2
    # korali-style uniform-experience sampling (Mini Batch Size = 256,
    # run-vracer-burger.py:132) with stored, lazily-refreshed retrace values —
    # vs the default "episode" mode (whole-episode minibatches, exact V-trace
    # tails under the current network).
    minibatch_mode: str = "episode"        # 'episode' | 'experience'
    mini_batch_size: int = 256
    experiences_between_updates: float = 0.5
    replay_start_experiences: int = 20000
    replay_max_experiences: int = 100000
    cutoff_scale: float = 4.0
    annealing_rate: float = 5e-8
    refer_beta: float = 0.3
    offpolicy_target: float = 0.1
    action_low: float = -5.0
    action_high: float = 5.0
    init_noise: float = 0.1       # iex
    state_rescaling: bool = True
    reward_rescaling: bool = True
    multi_agent_relationship: str = "individual"   # 'individual' | 'cooperation'
    multi_agent_correlation: bool = False
    value_coef: float = 1.0
    max_grad_norm: float = 10.0
    # Blowup containment: the reference envs emit reward = -inf on numeric
    # blowup (burger_environment.py:200) — an -inf entering replay turns
    # V-trace targets and the value loss into NaN and permanently poisons the
    # policy (observed: all later episodes die at step 1 on NaN actions).
    # Rewards are floored at this value inside the learner only; the env-side
    # parity (-inf) is untouched.  Set to -inf to disable.
    reward_floor: float = -1e4
    # Normalized observations are clipped to +-obs_clip standard deviations:
    # the last observations before a numeric blowup are astronomically large
    # (finite), and un-clipped they drive the value loss to inf and the
    # gradient-norm clip to NaN.  Set to inf to disable.
    obs_clip: float = 32.0
    # Samples whose |obs| exceeds this never enter the running normalizer
    # statistics (squaring a ~1e35 pre-blowup field overflows f32 and turns
    # the normalizer std into NaN for good).  Set to inf to disable.
    obs_stat_bound: float = 1e6
    # Exploration-sigma ceiling (networks.VracerNet.sigma_max): inf keeps
    # korali's unbounded sigma; a finite cap (e.g. the action range) prevents
    # the late-training sigma runaway observed on long spectral-reward runs.
    sigma_max: float = np.inf
    # Far-policy trust-region divergence: 'jeffreys' (symmetrized KL; see
    # distributions.kl_jeffreys for the sigma-ratchet rationale) or 'forward'
    # (the ReF-ER paper's KL(behavior||current)).
    trust_region: str = "jeffreys"
    # Numeric-blowup rewards (floored at reward_floor) are additionally
    # bounded AFTER reward rescaling: with a typical scale of ~1e-2 a raw
    # -1e4 floor becomes -1e6 in scaled units and detonates the value loss
    # (observed v_loss ~1e3 on flagship 907); korali's -inf would be worse.
    scaled_reward_floor: float = -100.0
    # korali State Rescaling semantics: coefficients are computed from the
    # replay-start buffer and FROZEN once policy updates begin (see
    # observe_episodes).  False keeps the round-2 continuously-updated stats.
    freeze_state_rescaling: bool = True
    # Reward-rescaling statistic source for the flat experience replay:
    # 'replay' = korali's live-buffer second moment (recomputed per update);
    # 'cumulative' = sqrt(E[r^2]) over every experience ever collected (the
    # Welford rew_stats).  The live-buffer scale SWINGS 2-3x between
    # generations on the burger flagship (runs/flagship_909: rew_scale
    # 0.0122 -> 0.0043 -> 0.0098 across gens 11..500), re-scaling the value
    # target each time and spiking v_loss (32/11.6/14.6 measured) — a
    # measured driver of the late-run peak decay.  'cumulative' drifts
    # monotonically slower as count grows.
    reward_scale_source: str = "replay"    # 'replay' | 'cumulative'
    # Winsorization of the cumulative reward-scale accumulator: entries are
    # clipped at this multiple of the current scale before entering rew_stats
    # (robust second moment; see observe_episodes).  0 disables.  Motivated
    # by flagship 911: one generation of -1e2..-1e3 spectral-error spikes
    # (above the blowup floor) inflated the Welford scale 80x forever.
    reward_stat_winsor: float = 10.0
    # Policy-mean parameterization (networks.VracerNet.mu_param):
    # 'sigma_relative' expresses the mean in units of the exploration stddev
    # (natural-gradient coordinates) so Adam's scale-free step moves the
    # policy proportionally to sigma — required for learnability when iex is
    # far below the action range (reference KS: iex=1e-3 on +-5,
    # run-vracer-ks.py:15,99-101; measured beta collapse in runs/ks_916.log).
    mu_param: str = "absolute"             # 'absolute' | 'sigma_relative'
    # Dimension-TEMPERED importance weights: korali's fixed cutoff c=4.0
    # bounds the JOINT log importance weight, which by CLT grows as
    # sqrt(d_action) * per-dim drift — so the per-dimension drift budget
    # shrinks as 1/sqrt(d) and a d=128 single-agent policy
    # (run-vracer-diffusion-simple.py:5-9: N=128, numAgents=1 -> 128 actions
    # per sample) is frozen at ~0.07 sigma TOTAL drift over the replay
    # lifetime (measured: runs/diffusion_961.log flat for 330k updates).
    # Worse, the raw joint rho itself is degenerate at high d (log rho ~
    # N(-d*delta^2/2, d*delta^2): almost all weights ~0, a few clipped), so
    # min(rho, c) silently shrinks the effective policy-gradient batch to the
    # freshest experiences.  With True, EVERY use of the importance weight —
    # near-policy test, pg truncation, retrace/V-trace clipping, replay
    # off-policy fraction — uses the tempered weight
    #     rho_tilde = rho ** (1/sqrt(d))
    # against the korali cutoff: dimension-invariant drift budget and
    # bounded, smoothly recency-weighted pg samples (tempered/flattened IS,
    # the standard variance control).  Exactly korali at d=1.
    cutoff_dim_norm: bool = False
    # Episode-ring capacity of the flat experience replay (experience mode);
    # None -> max(replay_max_experiences // 4, 1024).  Episodes averaging
    # fewer than max_experiences/this steps could wrap the episode ring while
    # their experiences are still live (only degrades truncated-episode
    # bootstraps; experience data itself is immune).
    replay_episode_capacity: int | None = None

    @property
    def replay_capacity_episodes(self) -> int:
        return max(self.replay_max_experiences // self.episode_length, 1)

    @property
    def replay_start_episodes(self) -> int:
        return max(self.replay_start_experiences // self.episode_length, 1)

    @property
    def flat_episode_capacity(self) -> int:
        if self.replay_episode_capacity is not None:
            return self.replay_episode_capacity
        return max(self.replay_max_experiences // 4, 1024)


class TrainState(PyTreeNode):
    params: Any
    opt_state: Any
    beta: jax.Array
    n_updates: jax.Array
    obs_stats: running_stats.RunningStats
    rew_stats: running_stats.RunningStats


def make_net(cfg: VracerConfig) -> networks.VracerNet:
    return networks.VracerNet(act_dim=cfg.act_dim, width=cfg.width,
                              n_hidden=cfg.n_hidden, init_noise=cfg.init_noise,
                              sigma_max=cfg.sigma_max, mu_param=cfg.mu_param)


def _joint_dims(cfg: VracerConfig) -> int:
    """Action dimensions entering one joint log importance ratio: act_dim,
    times num_agents under Multi Agent Correlation."""
    return cfg.act_dim * (cfg.num_agents if (cfg.multi_agent_correlation
                                             and cfg.num_agents > 1) else 1)


def _rho_temper(cfg: VracerConfig) -> float:
    """Exponent applied to the joint importance weight (log-ratio divided by
    sqrt(d)) under cutoff_dim_norm — see the config field's rationale.  1.0
    (korali-exact) otherwise, and always at d=1."""
    if not cfg.cutoff_dim_norm:
        return 1.0
    return 1.0 / float(np.sqrt(_joint_dims(cfg)))


def make_optimizer(cfg: VracerConfig):
    return optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                       optax.adam(cfg.lr))


def init_train(cfg: VracerConfig, key, dtype=jnp.float32) -> TrainState:
    net = make_net(cfg)
    params = net.init(key, jnp.zeros((1, cfg.obs_dim), dtype))
    opt_state = make_optimizer(cfg).init(params)
    return TrainState(
        params=params, opt_state=opt_state,
        beta=jnp.asarray(cfg.refer_beta, dtype),
        n_updates=jnp.zeros((), jnp.int32),
        obs_stats=running_stats.init((cfg.obs_dim,), dtype),
        rew_stats=running_stats.init((), dtype))


def _prep_obs(cfg: VracerConfig, ts: TrainState, obs):
    x = running_stats.normalize(ts.obs_stats, obs) if cfg.state_rescaling else obs
    if np.isfinite(cfg.obs_clip):
        x = jnp.clip(x, -cfg.obs_clip, cfg.obs_clip)
    return x


def policy_apply(cfg: VracerConfig, ts: TrainState, obs):
    """obs (..., obs_dim) -> (V, mu, sigma)."""
    return make_net(cfg).apply(ts.params, _prep_obs(cfg, ts, obs))


def act(cfg: VracerConfig, ts: TrainState, obs, key):
    """Sample actions; returns (actions, mu, sigma).  obs: (..., na, obs_dim)."""
    _, mu, sigma = policy_apply(cfg, ts, obs)
    a = D.sample(key, mu, sigma, cfg.action_low, cfg.action_high)
    return a, mu, sigma


def act_deterministic(cfg: VracerConfig, ts: TrainState, obs):
    _, mu, sigma = policy_apply(cfg, ts, obs)
    return jnp.clip(mu, cfg.action_low, cfg.action_high)


def observe_episodes(cfg: VracerConfig, ts: TrainState, batch) -> TrainState:
    """Update normalizer statistics from freshly collected episodes.

    korali freezes State Rescaling after the initial exploration phase: the
    coefficients are computed once from the replay-start buffer and applied
    unchanged for the rest of the run, so the network never chases a drifting
    input normalization.  We reproduce that by accumulating observation stats
    only until the first policy update (``freeze_state_rescaling``)."""
    new_obs = ts.obs_stats
    new_rew = ts.rew_stats
    mask_sa = jnp.broadcast_to(batch["mask"][..., None], batch["rewards"].shape)
    if cfg.state_rescaling:
        m = jnp.broadcast_to(batch["mask"][..., None, None],
                             batch["obs"].shape[:-1] + (1,))
        if np.isfinite(cfg.obs_stat_bound):
            ok = (jnp.abs(batch["obs"]).max(-1, keepdims=True)
                  <= cfg.obs_stat_bound)
            m = m * ok.astype(m.dtype)
        if cfg.freeze_state_rescaling:
            m = m * (ts.n_updates == 0).astype(m.dtype)
        new_obs = running_stats.update(
            new_obs, batch["obs"].reshape(-1, cfg.obs_dim),
            weights=m.reshape(-1))
    if cfg.reward_rescaling:
        # blowup rewards (raw <= reward_floor, e.g. the reference's -inf)
        # are EXCLUDED from the statistic, mirroring replay_flat.reward_scale:
        # one floored -1e4 in ~1e-2 ordinary rewards inflates the scale
        # ~3000x and crushes the real learning signal (measured rew_scale
        # 0.01 -> 571 on flagship 907; ADVICE r3)
        w = mask_sa
        if np.isfinite(cfg.reward_floor):
            w = w * (batch["rewards"] > cfg.reward_floor).astype(w.dtype)
        r_stat = jnp.maximum(batch["rewards"], cfg.reward_floor)
        if cfg.reward_stat_winsor > 0:
            # Winsorize the accumulator: non-blowup reward SPIKES (spectral
            # rel-err explosions in the -1e2..-1e3 range, above the -1e4
            # floor) permanently poison the cumulative Welford scale — one
            # bad generation inflated flagship 911's rew_scale 0.011 -> 0.87
            # (80x), crushing every later scaled reward.  Entries are clipped
            # at winsor * the CURRENT scale (robust second moment); skipped
            # until the accumulator has seen enough mass for the current
            # scale to mean anything.
            cur = running_stats.second_moment(ts.rew_stats)
            warm = ts.rew_stats.count > 1000.0
            # Warm-up guard (ADVICE r4): before the accumulator is warm the
            # cumulative scale is meaningless, but a spike generation DURING
            # warm-up can still permanently inflate it (the flagship-911
            # failure mode this channel targets).  Until warm, clip against
            # the batch's own robust scale — winsor * the MEDIAN of the valid
            # |rewards| in this very batch (median, not a high quantile: it
            # stays bulk-anchored under <50% spike contamination, and
            # winsor*median(|N(0,s)|) ~ 6.7s leaves the legitimate Gaussian
            # tail untouched).
            def batch_median(_):
                # the median is a full sort of the generation's rewards —
                # lax.cond keeps it off the hot path once the accumulator
                # is warm (it cost ~15% of a fused flagship generation)
                absr = jnp.where(w > 0, jnp.abs(r_stat), jnp.nan)
                q = jnp.nanquantile(absr.reshape(-1), 0.5)
                return jnp.where(jnp.isnan(q), 0.0, jnp.maximum(q, 1e-30))

            ref = jax.lax.cond(warm, lambda _: cur, batch_median, None)
            lim = cfg.reward_stat_winsor * ref
            r_stat = jnp.clip(r_stat, -lim, lim)
        new_rew = running_stats.update(new_rew, r_stat.reshape(-1),
                                       weights=w.reshape(-1))
    return ts.replace(obs_stats=new_obs, rew_stats=new_rew)


def _vtrace(V, rewards, rho, mask, gamma, bootstrap=None):
    """V-trace targets along T with clipped one-sample IS weights.

    V, rewards, rho, mask: (..., T).  Episode-end semantics follow the
    reference (burger_environment.py:198-204): a normal (time-limit or
    early-stop) end is "Terminal" — no bootstrap; a numeric-blowup end is
    "Truncated" — korali bootstraps the tail from V(s_T).  ``bootstrap``
    (..., broadcastable against V[..., 0]) carries that V(s_T) value,
    already zeroed for non-truncated episodes; it is added as the successor
    value at each episode's last valid step.
    Returns (vtg, adv): targets and advantages r_t + gamma*vtg_{t+1} - V_t.
    """
    rewards = rewards.astype(V.dtype)
    mask = mask.astype(V.dtype)
    rho_bar = jnp.minimum(rho, 1.0).astype(V.dtype)
    T = V.shape[-1]
    V_next = jnp.concatenate([V[..., 1:], jnp.zeros_like(V[..., :1])], axis=-1)
    next_valid = jnp.concatenate([mask[..., 1:], jnp.zeros_like(mask[..., :1])], axis=-1)
    V_next = V_next * next_valid
    if bootstrap is not None:
        # 1 exactly at the last valid step of each episode
        last_valid = mask * (1.0 - next_valid)
        bootstrap = bootstrap.astype(V.dtype)
        V_next = V_next + (last_valid * bootstrap[..., None]).astype(V.dtype)
    delta = rho_bar * (rewards + gamma * V_next - V)

    def body(carry, xs):
        # carry: vtg_{t+1} - V_{t+1}
        d, rb, nv = xs
        corr = d + gamma * rb * carry * nv
        return corr, corr

    xs = (jnp.moveaxis(delta, -1, 0),
          jnp.moveaxis(rho_bar, -1, 0), jnp.moveaxis(next_valid, -1, 0))
    _, corr_rev = jax.lax.scan(
        lambda c, x: body(c, x), jnp.zeros_like(V[..., 0]),
        jax.tree.map(lambda a: a[::-1], xs))
    corr = jnp.moveaxis(corr_rev[::-1], 0, -1)      # vtg_t - V_t
    vtg = V + corr
    vtg_next = jnp.concatenate([vtg[..., 1:], jnp.zeros_like(vtg[..., :1])], axis=-1)
    vtg_next = vtg_next * next_valid
    if bootstrap is not None:
        vtg_next = vtg_next + last_valid * bootstrap[..., None]
    adv = rewards + gamma * vtg_next - V
    return vtg, adv


def _loss(cfg: VracerConfig, params, ts: TrainState, batch, cutoff):
    net = make_net(cfg)
    obs = _prep_obs(cfg, ts, batch["obs"])
    V, mu, sigma = net.apply(params, obs)          # (K, T, na[, A])

    rewards = jnp.maximum(batch["rewards"], cfg.reward_floor)
    if cfg.reward_rescaling:
        rewards = running_stats.scale(ts.rew_stats, rewards)
    rewards = jnp.maximum(rewards, cfg.scaled_reward_floor)
    if cfg.multi_agent_relationship == "cooperation":
        # korali Cooperation: agents share the team-mean reward
        rewards = jnp.broadcast_to(rewards.mean(-1, keepdims=True), rewards.shape)

    logp = D.joint_log_prob(batch["actions"], mu, sigma,
                            cfg.action_low, cfg.action_high)
    logp_b = D.joint_log_prob(batch["actions"], batch["mu"], batch["sigma"],
                              cfg.action_low, cfg.action_high)
    log_ratio = logp - logp_b
    if cfg.multi_agent_correlation and cfg.num_agents > 1:
        # korali "Multi Agent Correlation" (run-vracer-burger-marl.py:113):
        # the agents' simultaneous actions are one joint policy sample, so the
        # importance weight is the PRODUCT over agents, shared by every
        # agent's experience at that timestep (sum of per-agent log-ratios).
        log_ratio = jnp.broadcast_to(log_ratio.sum(-1, keepdims=True),
                                     log_ratio.shape)
    # dimension temper (identity unless cutoff_dim_norm; see VracerConfig)
    log_ratio = jnp.clip(log_ratio * _rho_temper(cfg), -20.0, 20.0)
    rho = jnp.exp(log_ratio)
    near = (rho > 1.0 / cutoff) & (rho < cutoff)

    # Truncated-episode bootstrap (burger_environment.py:198-204): blowup ends
    # bootstrap the V-trace tail from V(s_T).  The pre-blowup final obs can be
    # astronomically large or NaN; sanitize before the network (the clip in
    # _prep_obs handles magnitude, nan_to_num handles NaN).
    bootstrap = None
    if "final_obs" in batch:
        fin = jnp.nan_to_num(batch["final_obs"], nan=0.0,
                             posinf=cfg.obs_stat_bound,
                             neginf=-cfg.obs_stat_bound)
        V_fin, _, _ = net.apply(params, _prep_obs(cfg, ts, fin))  # (K, na)
        trunc = batch["truncated"].astype(V_fin.dtype)            # (K,)
        bootstrap = jax.lax.stop_gradient(V_fin) * trunc[..., None]

    mask = batch["mask"][..., None]                # (K, T, 1) broadcast over agents
    # time axis is 1; move to last for the scan
    Vt = jnp.moveaxis(V, 1, -1)
    rt = jnp.moveaxis(rewards, 1, -1)
    rhot = jnp.moveaxis(rho, 1, -1)
    mt = jnp.moveaxis(jnp.broadcast_to(mask, rho.shape), 1, -1)
    vtg, adv = _vtrace(jax.lax.stop_gradient(Vt), rt,
                       jax.lax.stop_gradient(rhot), mt, cfg.gamma,
                       bootstrap=bootstrap)
    vtg = jnp.moveaxis(vtg, -1, 1)
    adv = jnp.moveaxis(adv, -1, 1)

    w = jnp.broadcast_to(mask, rho.shape)
    denom = jnp.maximum(w.sum(), 1.0)

    v_loss = 0.5 * jnp.sum(w * (V - jax.lax.stop_gradient(vtg)) ** 2) / denom

    pg_w = jax.lax.stop_gradient(jnp.minimum(rho, cutoff) * adv * near)
    pg_loss = -jnp.sum(w * pg_w * logp) / denom

    kl = _trust_kl(cfg, batch["mu"], batch["sigma"], mu, sigma)
    far = jnp.asarray(~near, kl.dtype)
    kl_loss = jnp.sum(w * far * kl) / denom

    loss = cfg.value_coef * v_loss + ts.beta * pg_loss + (1.0 - ts.beta) * kl_loss
    frac_far = jnp.sum(w * far) / denom
    metrics = dict(loss=loss, v_loss=v_loss, pg_loss=pg_loss, kl_loss=kl_loss,
                   frac_far=frac_far, mean_rho=jnp.sum(w * rho) / denom,
                   mean_sigma=sigma.mean(), mean_mu=mu.mean(),
                   mean_V=jnp.sum(w * V) / denom)
    return loss, metrics


def _sanitized_final_V(cfg: VracerConfig, params, ts: TrainState, final_obs):
    """V(s_T) for the truncated-state bootstrap; pre-blowup observations can
    be NaN/huge, so sanitize before the network."""
    fin = jnp.nan_to_num(final_obs, nan=0.0, posinf=cfg.obs_stat_bound,
                         neginf=-cfg.obs_stat_bound)
    V_fin, _, _ = make_net(cfg).apply(params, _prep_obs(cfg, ts, fin))
    return V_fin


def _rescale_rewards(cfg: VracerConfig, rewards, scale):
    """Floor, divide by the korali reward-rescaling sigma, bound in scaled
    units (blowup containment, see scaled_reward_floor), and apply the MARL
    Cooperation pooling (team-mean reward, run-vracer-burger-marl.py:111)."""
    rewards = jnp.maximum(rewards, cfg.reward_floor) / scale
    rewards = jnp.maximum(rewards, cfg.scaled_reward_floor)
    if cfg.multi_agent_relationship == "cooperation":
        rewards = jnp.broadcast_to(rewards.mean(-1, keepdims=True), rewards.shape)
    return rewards


def _joint_rho(cfg: VracerConfig, actions, mu, sigma, mu_b, sigma_b):
    """Importance weight pi_cur/pi_behavior per (.., na); with Multi Agent
    Correlation the PRODUCT over agents is shared (run-vracer-burger-marl.py:113)."""
    logp = D.joint_log_prob(actions, mu, sigma, cfg.action_low, cfg.action_high)
    logp_b = D.joint_log_prob(actions, mu_b, sigma_b,
                              cfg.action_low, cfg.action_high)
    log_ratio = logp - logp_b
    if cfg.multi_agent_correlation and cfg.num_agents > 1:
        log_ratio = jnp.broadcast_to(log_ratio.sum(-1, keepdims=True),
                                     log_ratio.shape)
    # dimension temper (identity unless cutoff_dim_norm; see VracerConfig)
    log_ratio = jnp.clip(log_ratio * _rho_temper(cfg), -20.0, 20.0)
    return jnp.exp(log_ratio), logp


def _trust_kl(cfg: VracerConfig, mu_b, sigma_b, mu, sigma):
    if cfg.trust_region == "jeffreys":
        return D.kl_jeffreys(mu_b, sigma_b, mu, sigma)
    return D.kl_normal(mu_b, sigma_b, mu, sigma)


# Episodes per chunk of the insert-time value forward (flat_insert): a whole
# generation at once needs B*T*na rows of hidden activations — 1024 flagship
# episodes x 500 steps x 32 agents x width 256 is 16 GiB per hidden layer,
# and that generation ran out of an 80 GB GPU's memory.
VALUE_CHUNK_EPISODES = 64


def flat_insert(cfg: VracerConfig, ts: TrainState, frep, batch, axis=None):
    """korali processEpisode: when an episode enters the replay, compute its
    state values V(s), its on-policy (rho=1) retrace values in current
    scaled-reward units, and the truncated-state bootstrap V(s_T); then
    append the live steps to the flat experience ring.

    batch: episode tensors (B, T, na, ...) from collect_episodes.
    ``axis``: shard_map mesh axis name when ``frep`` is a device-local shard —
    the reward-rescaling statistic is then psum'd across shards so every
    device computes retrace values with the GLOBAL scale.
    """
    from marlpde_tpu.rl import replay_flat
    V = jax.lax.map(
        lambda o: make_net(cfg).apply(ts.params, _prep_obs(cfg, ts, o))[0],
        batch["obs"], batch_size=VALUE_CHUNK_EPISODES)
    if not cfg.reward_rescaling:
        scale = jnp.asarray(1.0, V.dtype)
    elif cfg.reward_scale_source == "cumulative":
        # rew_stats already folded these episodes in (observe_episodes runs
        # before flat_insert in both trainer paths) and is replicated on a
        # mesh, so no psum is needed
        scale = running_stats.second_moment(ts.rew_stats)
    else:
        s, n = replay_flat.reward_scale_sums(frep, cfg.reward_floor,
                                             extra=batch["rewards"],
                                             extra_mask=batch["mask"])
        if axis is not None:
            s = jax.lax.psum(s, axis)
            n = jax.lax.psum(n, axis)
        scale = replay_flat.scale_from_sums(s, n)
    rewards = _rescale_rewards(cfg, batch["rewards"], scale)
    boot = (_sanitized_final_V(cfg, ts.params, ts, batch["final_obs"])
            * batch["truncated"].astype(V.dtype)[..., None])
    mask = jnp.broadcast_to(batch["mask"][..., None], rewards.shape)
    vtg, _ = _vtrace(jnp.moveaxis(V, 1, -1), jnp.moveaxis(rewards, 1, -1),
                     jnp.ones_like(jnp.moveaxis(rewards, 1, -1)),
                     jnp.moveaxis(mask, 1, -1), cfg.gamma, bootstrap=boot)
    return replay_flat.add_episodes(frep, batch, sv=V,
                                    vtg=jnp.moveaxis(vtg, -1, 1), boot=boot)


def _loss_experience(cfg: VracerConfig, params, ts: TrainState, rows,
                     vtg_next, scale, cutoff):
    """korali VRACER loss over n iid sampled experiences: one-step value
    target through the (just-refreshed) stored retrace value of the
    successor experience, REFER near/far split for the policy terms."""
    net = make_net(cfg)
    V, mu, sigma = net.apply(params, _prep_obs(cfg, ts, rows["obs"]))  # (n, na)
    rewards = _rescale_rewards(cfg, rows["rewards"], scale)
    rho, logp = _joint_rho(cfg, rows["actions"], mu, sigma,
                           rows["mu"], rows["sigma"])
    near = (rho > 1.0 / cutoff) & (rho < cutoff)

    rho_bar = jax.lax.stop_gradient(jnp.minimum(rho, 1.0))
    Vsg = jax.lax.stop_gradient(V)
    td = rewards + cfg.gamma * vtg_next - Vsg
    vtarget = Vsg + rho_bar * td           # the refreshed retrace value
    adv = td

    n_tot = jnp.asarray(rho.size, V.dtype)
    v_loss = 0.5 * jnp.sum((V - vtarget) ** 2) / n_tot
    pg_w = jax.lax.stop_gradient(jnp.minimum(rho, cutoff) * adv * near)
    pg_loss = -jnp.sum(pg_w * logp) / n_tot
    kl = _trust_kl(cfg, rows["mu"], rows["sigma"], mu, sigma)
    far = jnp.asarray(~near, kl.dtype)
    kl_loss = jnp.sum(far * kl) / n_tot

    loss = cfg.value_coef * v_loss + ts.beta * pg_loss + (1.0 - ts.beta) * kl_loss
    metrics = dict(loss=loss, v_loss=v_loss, pg_loss=pg_loss, kl_loss=kl_loss,
                   frac_far=far.mean(), mean_rho=rho.mean(),
                   mean_sigma=sigma.mean(), mean_mu=mu.mean(), mean_V=V.mean())
    return loss, metrics


def update_experience(cfg: VracerConfig, ts: TrainState, frep, key,
                      axis=None, mini_batch: int | None = None):
    """One korali-faithful VRACER update on the flat experience replay.

    Order follows korali's trainingGeneration step (Agent::attendAgent ->
    generateMiniBatch -> runPolicy -> updateExperienceMetadata -> gradients):

      1. sample `mini_batch_size` experiences uniformly over the live buffer;
      2. forward the CURRENT policy on them; refresh their stored metadata —
         state value, importance weight, persistent off-policy flag — and the
         truncated-state bootstraps of the touched episodes;
      3. recompute the retrace values of the touched episodes' WHOLE
         experience chains (backward recursion, replay_flat.refresh_retrace);
      4. take the gradient step with the refreshed successor retrace values;
      5. anneal REFER beta against the REPLAY-WIDE off-policy fraction with
         the annealed learning rate (korali uses _currentLearningRate, i.e.
         lr / (1 + annealing_rate * n_updates) — measured over the buffer,
         NOT the minibatch).

    Returns (ts, frep, metrics).

    Distributed mode (``axis`` = shard_map mesh axis name): ``frep`` is a
    device-local shard and ``mini_batch`` the per-device slice of the global
    minibatch (mini_batch_size // n_devices).  Each device samples/refreshes
    its OWN shard (steps 1-3 are shard-local, like korali's single buffer cut
    into n pieces); gradients are pmean'd and the reward scale + off-policy
    fraction psum'd, so the parameter/beta update is bitwise-replicated.
    """
    from marlpde_tpu.rl import replay_flat
    f32 = jnp.float32
    n_upd = ts.n_updates.astype(f32)
    cutoff = cfg.cutoff_scale / (1.0 + cfg.annealing_rate * n_upd)
    g = replay_flat.sample_ids(frep, key, mini_batch or cfg.mini_batch_size)
    rows = replay_flat.gather(frep, g)
    if not cfg.reward_rescaling:
        scale = jnp.asarray(1.0, f32)
    elif cfg.reward_scale_source == "cumulative":
        scale = running_stats.second_moment(ts.rew_stats)
    else:
        s, n = replay_flat.reward_scale_sums(frep, cfg.reward_floor)
        if axis is not None:
            s = jax.lax.psum(s, axis)
            n = jax.lax.psum(n, axis)
        scale = replay_flat.scale_from_sums(s, n)

    # -- metadata refresh (pre-update policy, like korali) --
    V_meta, mu_c, sigma_c = make_net(cfg).apply(
        ts.params, _prep_obs(cfg, ts, rows["obs"]))
    rho_new, _ = _joint_rho(cfg, rows["actions"], mu_c, sigma_c,
                            rows["mu"], rows["sigma"])
    off_new = ~((rho_new > 1.0 / cutoff) & (rho_new < cutoff))
    boot_new = (_sanitized_final_V(cfg, ts.params, ts, rows["fin_obs"])
                * rows["truncated"].astype(V_meta.dtype)[..., None])
    frep = replay_flat.refresh_metadata(frep, g, V_meta, rho_new, off_new,
                                        boot_new)
    frep, vtg_next = replay_flat.refresh_retrace(
        frep, g, cfg.episode_length, cfg.gamma, scale, cfg.reward_floor,
        scaled_floor=cfg.scaled_reward_floor)

    grads, metrics = jax.grad(
        lambda p: _loss_experience(cfg, p, ts, rows, vtg_next, scale, cutoff),
        has_aux=True)(ts.params)
    if axis is not None:
        grads = jax.tree.map(lambda a: jax.lax.pmean(a, axis), grads)
    updates, opt_state = make_optimizer(cfg).update(grads, ts.opt_state, ts.params)
    params = optax.apply_updates(ts.params, updates)

    # REFER beta annealing over the replay-wide fraction
    if axis is not None:
        n_off, n_live = replay_flat.off_policy_sums(frep)
        frac_off = (jax.lax.psum(n_off, axis).astype(f32)
                    / jnp.maximum(jax.lax.psum(n_live, axis), 1).astype(f32))
    else:
        frac_off = replay_flat.off_policy_fraction(frep)
    lr_t = jnp.asarray(cfg.lr, ts.beta.dtype) / (1.0 + cfg.annealing_rate * n_upd)
    beta = jnp.where(frac_off > cfg.offpolicy_target,
                     (1.0 - lr_t) * ts.beta, (1.0 - lr_t) * ts.beta + lr_t)
    beta = jnp.clip(beta, 0.0, 1.0)
    metrics["beta"] = beta
    metrics["cutoff"] = cutoff
    metrics["frac_off_replay"] = frac_off
    metrics["rew_scale"] = scale
    return ts.replace(params=params, opt_state=opt_state, beta=beta,
                      n_updates=ts.n_updates + 1), frep, metrics


def update(cfg: VracerConfig, ts: TrainState, batch):
    """One gradient step on a sampled episode batch; returns (ts, metrics)."""
    cutoff = cfg.cutoff_scale / (1.0 + cfg.annealing_rate *
                                 ts.n_updates.astype(jnp.float32))
    grads, metrics = jax.grad(
        lambda p: _loss(cfg, p, ts, batch, cutoff), has_aux=True)(ts.params)
    updates, opt_state = make_optimizer(cfg).update(grads, ts.opt_state, ts.params)
    params = optax.apply_updates(ts.params, updates)

    # REFER beta adaptation (paper sec. 3.2): push frac_far toward target
    nu = jnp.asarray(cfg.lr * 10.0, ts.beta.dtype)
    beta = jnp.where(metrics["frac_far"] > cfg.offpolicy_target,
                     (1.0 - nu) * ts.beta,
                     (1.0 - nu) * ts.beta + nu)
    beta = jnp.clip(beta, 0.05, 1.0)

    metrics["beta"] = beta
    metrics["cutoff"] = cutoff
    return ts.replace(params=params, opt_state=opt_state, beta=beta,
                      n_updates=ts.n_updates + 1), metrics
