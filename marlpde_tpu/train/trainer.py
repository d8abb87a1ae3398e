"""Training orchestration: generations of on-device rollouts + REFER updates.

korali's generation loop (Episodes Per Generation = 10, run-vracer-burger.py:128)
becomes: collect `num_envs` episodes as ONE jitted scan, insert into the
on-device replay, then run gradient updates at a replay-reuse rate matching
korali's `Experiences Between Policy Updates` economics.

korali consumes 256 experiences per update at 1 update per 0.5 new experiences
=> replay reuse ~512x.  Our minibatch is whole episodes (K*T experiences), so
updates/generation = new_experiences * reuse_ratio / (K*T).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from marlpde_tpu.envs.rollout import Env, collect_episodes
from marlpde_tpu.rl import replay as replay_mod
from marlpde_tpu.rl import running_stats, vracer

# updates per jitted scan in trainer.train's unfused update loop (chunking is
# RNG-transparent; see make_update_scan).  Sized so korali economics
# (~100-10000 updates/gen) cost a handful of dispatches.
UPDATE_CHUNK = 50


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    num_envs: int = 16                 # episodes per generation
    max_experiences: float = 5e5       # korali Termination Criteria (run-vracer-burger.py:195)
    reuse_ratio: float = 512.0         # korali: 256 exp/update / 0.5 exp-between-updates
    max_updates_per_gen: int = 200
    seed: int = 42
    log_every: int = 1
    testing_frequency: int = 0         # generations between deterministic evals (0 = off)
    testing_episodes: int = 8
    # s["Custom Settings"]["Save Episode"] equivalent (run-vracer-burger.py:120,
    # burger_environment.py:207-238): dump collected episodes whose cumulative
    # reward clears a threshold (burger_fd_environment.py:211 saves > -1.0).
    save_episodes_dir: Optional[str] = None
    save_episodes_threshold: float = -np.inf
    # korali File Output {Enabled, Frequency, Path} (run-vracer-burger.py:
    # 198-201): periodic full checkpoints (train state + history + RNG/counter
    # meta, + replay when serialize_replay — korali "Experience Replay
    # Serialize").  A killed run resumed from these continues bitwise.
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 25
    serialize_replay: bool = False
    # fuse one whole generation (collect + replay insert + normalizer update +
    # all gradient updates) into a single jitted program: 1 dispatch per
    # generation instead of 3 + updates, with no host round trip between
    # them; the RNG stream is identical to the unfused path
    # (tests/test_rl.py::TestFusedGeneration).
    fused: bool = False
    # Decay-phase diagnostics (VERDICT r4 next #2): per-generation probe of
    # the policy on a FIXED batch of initial states — value estimate V(s0)
    # in scaled units, policy-mean drift ||mu_g - mu_{g-1}||_rms and
    # ||mu_g - mu_0||_rms, probe sigma, reward scale, and replay occupancy —
    # appended to history["diag"].  Off by default (one extra tiny dispatch
    # per generation).
    decay_diagnostics: bool = False
    # korali-faithful experience accounting: count only LIVE env-steps
    # (mask==1) toward Max Experiences, the replay-start gate, and the
    # update economics (updates/gen = real new experiences / `Experiences
    # Between Policy Updates`), exactly as korali does for early-terminating
    # episodes (diffusion_environment_simple.py:70-71 stops at cumreward<0,
    # so episodes contribute ~10-20 experiences, not episodeLength).  The
    # default False counts padded episodes (num_envs*T/gen) — cheaper (no
    # per-generation device-to-host mask readback) and equivalent for fixed-length
    # workloads.  Unfused path only (the fused program bakes a static update
    # count); train() falls back to unfused when set.
    count_real_experiences: bool = False


def default_rl_config(env: Env, **overrides) -> vracer.VracerConfig:
    kw = dict(obs_dim=env.obs_dim, act_dim=env.act_dim,
              num_agents=env.num_agents, episode_length=env.episode_length,
              action_low=env.action_low, action_high=env.action_high)
    kw.update(overrides)
    return vracer.VracerConfig(**kw)


def make_replay(env: Env, rl_cfg: vracer.VracerConfig):
    """The trainer's replay layout (shared with checkpoint load templates):
    episode-slot ring for episode minibatches, flat experience ring with
    korali REFER metadata (replay_flat) for experience minibatches."""
    if rl_cfg.minibatch_mode == "experience":
        from marlpde_tpu.rl import replay_flat
        return replay_flat.init_flat(rl_cfg.replay_max_experiences,
                                     rl_cfg.flat_episode_capacity,
                                     env.num_agents, env.obs_dim, env.act_dim)
    return replay_mod.init(rl_cfg.replay_capacity_episodes,
                           env.episode_length, env.num_agents,
                           env.obs_dim, env.act_dim)


def updates_per_generation(rl_cfg: vracer.VracerConfig, tc: TrainerConfig,
                           T: int) -> int:
    """korali economics: 1 update per `Experiences Between Policy Updates`
    new experiences, each consuming `Mini Batch Size` samples; replay reuse =
    mini_batch / exp_between.  Episode-mode minibatches are K*T experiences."""
    exp_per_update = (rl_cfg.mini_batch_size
                      if rl_cfg.minibatch_mode == "experience"
                      else rl_cfg.mini_batch_episodes * T)
    return int(min(tc.max_updates_per_gen,
                   max(1, tc.num_envs * T * tc.reuse_ratio / exp_per_update)))


def build_fused_generation(env: Env, rl_cfg: vracer.VracerConfig,
                           tc: TrainerConfig, upd_per_gen: int):
    """One whole training generation (collect + replay insert + normalizer
    update + all gradient updates) as a single jitted program: 1 dispatch per
    generation instead of 3 + updates.  RNG-key usage replicates the
    unfused loop exactly, so both paths are bitwise identical
    (tests/test_rl.py::TestFusedGeneration).  This is also the path bench.py
    times in BENCH_MODE=train."""
    exp_mode = rl_cfg.minibatch_mode == "experience"

    @jax.jit
    def fused_generation(ts_, rep_, k_c, k_u, episode_base_, consts):
        traj_, final_ = collect_episodes(
            env, rl_cfg, ts_, k_c, tc.num_envs, episode_base_, consts=consts,
            record_fields=tc.save_episodes_dir is not None)
        if exp_mode:
            ts_ = vracer.observe_episodes(rl_cfg, ts_, traj_)
            rep_ = vracer.flat_insert(rl_cfg, ts_, rep_, traj_)
        else:
            rep_ = replay_mod.add_episodes(rep_, traj_)
            ts_ = vracer.observe_episodes(rl_cfg, ts_, traj_)

        def run_updates(operand):
            t0_, r0_, k0 = operand

            def body(carry, _):
                t_, r_, kk = carry
                kk, ki = jax.random.split(kk)
                if exp_mode:
                    t_, r_, m = vracer.update_experience(rl_cfg, t_, r_, ki)
                else:
                    kb, _ = jax.random.split(ki)
                    batch = replay_mod.sample_episodes(
                        r_, kb, rl_cfg.mini_batch_episodes)
                    t_, m = vracer.update(rl_cfg, t_, batch)
                return (t_, r_, kk), m

            (t1, r1, _), ms = jax.lax.scan(body, (t0_, r0_, k0), None,
                                           length=upd_per_gen)
            return (t1, r1), jax.tree.map(lambda a: a[-1], ms)

        mshape = jax.eval_shape(run_updates, (ts_, rep_, k_u))[1]

        def skip_updates(operand):
            t0_, r0_, _ = operand
            return (t0_, r0_), jax.tree.map(
                lambda s: jnp.zeros(s.shape, s.dtype), mshape)

        did = (rep_.cursor >= rl_cfg.replay_start_experiences if exp_mode
               else rep_.filled >= rl_cfg.replay_start_episodes)
        (ts_, rep_), metrics_ = jax.lax.cond(did, run_updates, skip_updates,
                                             (ts_, rep_, k_u))
        stats = dict(
            mean_return=final_.cum_reward.reshape(tc.num_envs, -1).mean(),
            ep_len=traj_["mask"].sum(1).mean(),
            n_upd=jnp.where(did, upd_per_gen, 0),
            # blowup/containment diagnostics (VERDICT r4 weak #7): a -inf
            # generation return must be interpretable from the bench artifact
            blowups=traj_["truncated"].sum(),
            rew_scale=running_stats.second_moment(ts_.rew_stats))
        return ts_, rep_, traj_, final_, metrics_, stats

    return fused_generation


def train(env: Env, rl_cfg: Optional[vracer.VracerConfig] = None,
          tc: TrainerConfig = TrainerConfig(), verbose: bool = True,
          callback=None, init_ts=None, init_history=None, init_replay=None,
          init_key=None, init_counters: Optional[dict] = None):
    """Run training; returns (train_state, replay, history dict).

    Resume (the korali e.loadState equivalent, run-vracer-burger.py:59-62):
    ``init_ts``/``init_history`` restore the learner and curves;
    ``init_replay`` the experience buffer (korali Experience Replay
    Serialize); ``init_key``/``init_counters`` (dict with gen / total_exp /
    episode_base, from checkpoint.load_meta) the RNG stream and counters — a
    killed-and-resumed run then continues bitwise-identically.  Without
    meta, counters fall back to the restored history (RNG restarts)."""
    rl_cfg = rl_cfg or default_rl_config(env)
    key = init_key if init_key is not None else jax.random.key(tc.seed)
    if init_ts is None:
        key, k_init = jax.random.split(key)
        ts = vracer.init_train(rl_cfg, k_init)
    elif init_key is None:
        key, _ = jax.random.split(key)   # keep the legacy resume stream
        ts = init_ts
    else:
        ts = init_ts

    rep = init_replay if init_replay is not None else make_replay(env, rl_cfg)

    collect = jax.jit(lambda ts_, key_, base, consts: collect_episodes(
        env, rl_cfg, ts_, key_, tc.num_envs, base, consts=consts,
        record_fields=tc.save_episodes_dir is not None))
    collect_det = jax.jit(lambda ts_, key_, base, consts: collect_episodes(
        env, rl_cfg, ts_, key_, tc.testing_episodes, base, deterministic=True,
        consts=consts))
    add = jax.jit(replay_mod.add_episodes)
    observe = jax.jit(lambda ts_, b: vracer.observe_episodes(rl_cfg, ts_, b))
    exp_mode = rl_cfg.minibatch_mode == "experience"
    insert_flat = jax.jit(lambda ts_, r_, b: vracer.flat_insert(rl_cfg, ts_, r_, b))

    @jax.jit
    def do_update(ts_, rep_, key_):
        kb, _ = jax.random.split(key_)
        batch = replay_mod.sample_episodes(rep_, kb, rl_cfg.mini_batch_episodes)
        ts2, metrics = vracer.update(rl_cfg, ts_, batch)
        return ts2, rep_, metrics

    @jax.jit
    def do_update_exp(ts_, rep_, key_):
        return vracer.update_experience(rl_cfg, ts_, rep_, key_)

    step_fn = do_update_exp if exp_mode else do_update

    def make_update_scan(n):
        """n sequential updates as ONE program, threading the generation
        update key exactly like the legacy per-dispatch loop
        (k_u, k_i = split(k_u) per step), so the key stream — and therefore
        the whole run — is bitwise-identical for any chunking."""
        @jax.jit
        def run(ts_, rep_, k_u_):
            def body(carry, _):
                ts_c, rep_c, k_c = carry
                k2, k_i = jax.random.split(k_c)
                ts2, rep2, m = step_fn(ts_c, rep_c, k_i)
                return (ts2, rep2, k2), m
            (ts2, rep2, k2), ms = jax.lax.scan(
                body, (ts_, rep_, k_u_), None, length=n)
            return ts2, rep2, k2, jax.tree.map(lambda x: x[-1], ms)
        return run

    run_update_chunk = make_update_scan(UPDATE_CHUNK)
    _rem_cache = {}

    def run_update_rem(n):
        if n not in _rem_cache:
            _rem_cache[n] = make_update_scan(n)
        return _rem_cache[n]

    from marlpde_tpu.utils.profiling import Throughput
    throughput = Throughput()
    history = init_history if init_history else dict(
        gen=[], experiences=[], mean_return=[], mean_ep_len=[],
        updates=[], metrics=[], test_return=[], wall_time=[],
        env_steps_per_s=[])
    history.setdefault("env_steps_per_s", [])
    if init_counters is not None:
        gen = init_counters["gen"]
        total_exp = init_counters["total_exp"]
        episode_base = init_counters["episode_base"]
    else:
        total_exp = history["experiences"][-1] if history.get("experiences") else 0
        episode_base = (history["gen"][-1] if history.get("gen") else 0) * tc.num_envs
        gen = history["gen"][-1] if history.get("gen") else 0
    t0 = time.time()
    updates_done = int(sum(history.get("updates") or [0]))
    best_test = [max([t for t in history.get("test_return", [])] or
                     [-np.inf])]
    T = env.episode_length
    new_exp_per_gen = tc.num_envs * T
    upd_per_gen = updates_per_generation(rl_cfg, tc, T)
    fused_generation = build_fused_generation(env, rl_cfg, tc, upd_per_gen)
    real_mode = tc.count_real_experiences
    exp_per_update = (rl_cfg.mini_batch_size if exp_mode
                      else rl_cfg.mini_batch_episodes * T)
    # Cumulative live experiences inserted (korali's _experienceCount): drives
    # the replay-start gate AND the cumulative update ledger below.  On resume
    # it MUST be restored — restarting it at 0 while updates_done is restored
    # from history makes the ledger shortfall 0 until the run re-collects
    # replay_start + updates_done*expperu NEW experiences (i.e. zero updates
    # for most of the resumed run; ADVICE r3, high).  In real mode total_exp
    # itself counts only live experiences, so it is the exact fallback when an
    # older checkpoint lacks the dedicated meta field.
    if init_counters is not None and init_counters.get("real_in_replay") is not None:
        real_in_replay = int(init_counters["real_in_replay"])
    elif real_mode and total_exp:
        real_in_replay = int(total_exp)
    else:
        real_in_replay = 0

    prev_probe_mu = init_probe_mu = None
    if tc.decay_diagnostics:
        history.setdefault("diag", [])
        n_probe = 32
        probe_keys = jax.random.split(jax.random.key(tc.seed + 777), n_probe)
        _, probe_obs = jax.jit(lambda c, ks, cs: jax.vmap(
            lambda k_, c_: env.reset(c, k_, c_))(ks, cs))(
            env.consts, probe_keys, jnp.arange(n_probe))

        @jax.jit
        def probe_fn(ts_):
            V, mu, sigma = vracer.policy_apply(rl_cfg, ts_, probe_obs)
            return (V.mean(), mu, sigma.mean(),
                    running_stats.second_moment(ts_.rew_stats))

    while total_exp < tc.max_experiences:
        key, k_c, k_u = jax.random.split(key, 3)
        if tc.fused and not real_mode:
            ts, rep, traj, final, metrics, stats = fused_generation(
                ts, rep, k_c, k_u, jnp.asarray(episode_base), env.consts)
            episode_base += tc.num_envs
            gen_exp = new_exp_per_gen
            total_exp += gen_exp
            gen += 1
            n_upd = int(stats["n_upd"])
            metrics = metrics if n_upd else {}
        else:
            traj, final = collect(ts, k_c, jnp.asarray(episode_base), env.consts)
            if exp_mode:
                ts = observe(ts, traj)
                rep = insert_flat(ts, rep, traj)
            else:
                rep = add(rep, traj)
                ts = observe(ts, traj)
            episode_base += tc.num_envs
            if real_mode:
                gen_exp = int(np.asarray(traj["mask"]).sum())
                real_in_replay += gen_exp
            else:
                gen_exp = new_exp_per_gen
            total_exp += gen_exp
            gen += 1

            metrics = {}
            n_upd = 0
            if real_mode:
                started = real_in_replay >= rl_cfg.replay_start_experiences
                if exp_mode:
                    # korali's exact update ledger: the cumulative target is
                    # (experienceCount - startSize) / Experiences Between
                    # Policy Updates; each generation runs the shortfall
                    # against updates already taken (capped by --maxupd).
                    target_total = int(max(
                        0.0, (real_in_replay - rl_cfg.replay_start_experiences)
                        / rl_cfg.experiences_between_updates))
                    n_target = (min(tc.max_updates_per_gen,
                                    max(0, target_total - updates_done))
                                if started else 0)
                else:
                    n_target = (int(min(tc.max_updates_per_gen,
                                        max(0.0, gen_exp * tc.reuse_ratio
                                            / exp_per_update)))
                                if started else 0)
            else:
                started = (int(rep.cursor) >= rl_cfg.replay_start_experiences
                           if exp_mode
                           else int(rep.filled) >= rl_cfg.replay_start_episodes)
                n_target = upd_per_gen if started else 0
            # chunked update scans: same key-split sequence as n_target
            # individual dispatches (bitwise-identical to the legacy loop and
            # to the fused program), but ~UPDATE_CHUNK x fewer dispatches —
            # the per-dispatch overhead dominated generations with korali
            # economics (hundreds of updates/gen)
            n_full, rem = divmod(n_target, UPDATE_CHUNK)
            for _ in range(n_full):
                ts, rep, k_u, metrics = run_update_chunk(ts, rep, k_u)
                n_upd += UPDATE_CHUNK
            if rem:
                ts, rep, k_u, metrics = run_update_rem(rem)(ts, rep, k_u)
                n_upd += rem

        updates_done += n_upd
        mean_ret = float(final.cum_reward.mean())
        ep_len = float(traj["mask"].sum(1).mean())
        history["gen"].append(gen)
        history["experiences"].append(total_exp)
        history["mean_return"].append(mean_ret)
        history["mean_ep_len"].append(ep_len)
        history["updates"].append(n_upd)
        history["metrics"].append({k: float(v) for k, v in metrics.items()})
        history["wall_time"].append(time.time() - t0)
        throughput.tick(gen_exp)
        history["env_steps_per_s"].append(throughput.rate())

        if tc.decay_diagnostics:
            v0, mu_p, sig_p, rscale = probe_fn(ts)
            mu_p = np.asarray(mu_p)
            if init_probe_mu is None:
                init_probe_mu = mu_p
            rms = lambda a: float(np.sqrt(np.mean(a * a)))
            if rl_cfg.minibatch_mode == "experience":
                occ = int(min(int(np.asarray(rep.cursor)),
                              rl_cfg.replay_max_experiences))
            else:
                occ = int(np.asarray(rep.filled))
            history["diag"].append(dict(
                # V(s0) and the realized return, both in SCALED units —
                # their gap is the value bias the decay investigation needs
                v0_scaled=float(v0),
                return_scaled=float(mean_ret / max(float(rscale), 1e-30)),
                rew_scale=float(rscale),
                mu_drift_rms=(rms(mu_p - prev_probe_mu)
                              if prev_probe_mu is not None else 0.0),
                mu_from_init_rms=rms(mu_p - init_probe_mu),
                mu_rms=rms(mu_p), sigma_probe=float(sig_p),
                replay_occupancy=occ))
            prev_probe_mu = mu_p

        if tc.save_episodes_dir:
            # cum_reward is (B,) for single-return envs, (B, na) for MARL
            cum = np.asarray(final.cum_reward).reshape(tc.num_envs, -1).mean(-1)
            keep = cum > tc.save_episodes_threshold
            if keep.any():
                os.makedirs(tc.save_episodes_dir, exist_ok=True)
                # reference save-episode content (burger_environment.py:
                # 207-238): solved fields (sgs_u), cumulative spectra
                # (sgs_Ektt), action history (sgs_actions), DNS pool indices
                # (indeces) — plus the RL tensors
                extra = {}
                if "fields" in traj:
                    extra["fields"] = np.asarray(traj["fields"])[keep]
                if "ektt" in traj:
                    extra["ektt"] = np.asarray(traj["ektt"])[keep]
                if hasattr(final, "sidx"):
                    extra["indeces"] = np.asarray(final.sidx)[keep]
                np.savez_compressed(
                    os.path.join(tc.save_episodes_dir, f"episodes_gen{gen}.npz"),
                    actions=np.asarray(traj["actions"])[keep],
                    rewards=np.asarray(traj["rewards"])[keep],
                    obs=np.asarray(traj["obs"])[keep],
                    cumreward=np.asarray(final.cum_reward)[keep], **extra)

        if tc.testing_frequency and gen % tc.testing_frequency == 0:
            key, k_t = jax.random.split(key)
            ttraj, tfinal = collect_det(ts, k_t, jnp.asarray(0), env.consts)
            tret = float(tfinal.cum_reward.mean())
            history["test_return"].append(tret)
            # best-policy checkpoint (by deterministic test return): long
            # off-policy runs can degrade past their peak; `--test --best`
            # evaluates the peak policy instead of the final one
            if tc.checkpoint_dir and tret > best_test[0]:
                best_test[0] = tret
                from marlpde_tpu.utils import checkpoint as ckpt
                ckpt.save_train_state(os.path.join(tc.checkpoint_dir, "best"),
                                      ts, None)
                with open(os.path.join(tc.checkpoint_dir, "best",
                                       "best.json"), "w") as f:
                    import json as _json
                    _json.dump({"gen": gen, "test_return": tret}, f)
        if tc.checkpoint_dir and gen % tc.checkpoint_every == 0:
            from marlpde_tpu.utils import checkpoint as ckpt
            ckpt.save_train_state(tc.checkpoint_dir, ts, history)
            ckpt.save_meta(tc.checkpoint_dir, key, gen, total_exp, episode_base,
                           real_in_replay=real_in_replay, rl_cfg=rl_cfg)
            if tc.serialize_replay:
                ckpt.save_replay(tc.checkpoint_dir, rep)
        if verbose and gen % tc.log_every == 0:
            print(f"[trainer] gen {gen} exp {total_exp} return {mean_ret:.5f} "
                  f"eplen {ep_len:.1f} updates {n_upd} "
                  f"beta {metrics.get('beta', '-')}", flush=True)
        if callback is not None:
            callback(gen, ts, rep, history)

    if tc.checkpoint_dir:
        from marlpde_tpu.utils import checkpoint as ckpt
        ckpt.save_train_state(tc.checkpoint_dir, ts, history)
        ckpt.save_meta(tc.checkpoint_dir, key, gen, total_exp, episode_base,
                       real_in_replay=real_in_replay, rl_cfg=rl_cfg)
        if tc.serialize_replay:
            ckpt.save_replay(tc.checkpoint_dir, rep)
    return ts, rep, history


def evaluate(env: Env, rl_cfg, ts, key, n_episodes: int = 8):
    """Deterministic-policy evaluation; returns per-episode returns (n,na).

    Jitted with consts passed as an ARGUMENT (not closed over), so the pool
    is not baked into the program as a constant."""
    run = jax.jit(lambda ts_, key_, consts: collect_episodes(
        env, rl_cfg, ts_, key_, n_episodes, 0, deterministic=True,
        consts=consts))
    _traj, final = run(ts, key, env.consts)
    return np.asarray(final.cum_reward)
