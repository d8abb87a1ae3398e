"""Device-mesh distribution: env shards + data-parallel learner.

The reference has no distributed execution at all (SURVEY.md §2.8: single
SLURM task, OMP threads inside korali).  The scaling axis here is the
*environment batch*: thousands of envs advance in lockstep, sharded over a 1-D
'env' mesh axis; the learner is data-parallel with psum gradient reduction
inside shard_map.  Multi-host runs extend the same mesh over
jax.distributed-initialized processes; collectives are XLA's (NCCL on GPUs).

One generation = one XLA computation per device:
  collect episodes (policy-in-scan) -> insert into the local replay shard ->
  K gradient updates on locally sampled minibatches with pmean'd grads.
Parameters, optimizer state and normalizer stats stay replicated (identical
update applied on every device); replay shards are device-local (never
gathered) — the korali-equivalent 100k-experience buffer becomes
100k/n_devices per device.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from marlpde_tpu.envs.rollout import Env, collect_episodes
from marlpde_tpu.rl import replay as replay_mod
from marlpde_tpu.rl import vracer


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None):
    """Multi-host init (idempotent).  Under SLURM jax.distributed discovers
    the cluster itself (scripts/submit_jobs.py --multi-node); explicit args
    support manual launches.  Safe no-op single-host."""
    try:
        if coordinator is not None:
            jax.distributed.initialize(coordinator_address=coordinator,
                                       num_processes=num_processes,
                                       process_id=process_id)
        elif "SLURM_JOB_NUM_NODES" in __import__("os").environ:
            jax.distributed.initialize()
    except RuntimeError:
        pass  # already initialized


def make_mesh(devices=None, axis: str = "env") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def replicate(mesh: Mesh, tree):
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def shard_leading(mesh: Mesh, tree, axis: str = "env"):
    """Shard array leaves on their leading axis; replicate scalar leaves."""
    def put(a):
        spec = P(axis) if jnp.ndim(a) else P()
        return jax.device_put(a, NamedSharding(mesh, spec))
    return jax.tree.map(put, tree)


def leading_specs(tree, axis: str = "env"):
    """PartitionSpec pytree: P(axis) for arrays, P() for scalars."""
    return jax.tree.map(lambda a: P(axis) if jnp.ndim(a) else P(), tree)


def make_sharded_generation(env: Env, rl_cfg: vracer.VracerConfig, mesh: Mesh,
                            envs_per_device: int, updates_per_gen: int,
                            axis: str = "env"):
    """Build the jitted one-generation function over the mesh.

    Returns (gen_fn, init_replay_shards):
      gen_fn(ts, rep_shard, key, episode_base) -> (ts, rep_shard, stats)
    where rep_shard's leading (capacity) axis is sharded over `axis`, ts is
    replicated, and stats carries mean return / episode length.

    Both minibatch modes are supported with the SAME semantics as the
    single-chip trainer (a --mesh run must not silently train a different
    algorithm — ADVICE r3):
      * "episode": device-local episode-slot replay shards, episode
        minibatches, pmean'd grads, minibatch-frac_far beta (as before);
      * "experience" (the run.py default): device-local FLAT replay shards
        (korali's single buffer cut into n_dev slices), per-device
        mini_batch_size/n_dev uniform samples with shard-local metadata +
        retrace refresh, pmean'd grads, psum'd replay-wide off-policy
        fraction and reward scale — korali's exact REFER economics, sharded.
    """
    n_dev = mesh.devices.size
    exp_mode = rl_cfg.minibatch_mode == "experience"
    if exp_mode:
        from marlpde_tpu.rl import replay_flat
        flat_cap = max(rl_cfg.replay_max_experiences // n_dev,
                       envs_per_device * rl_cfg.episode_length)
        flat_ep_cap = max(rl_cfg.flat_episode_capacity // n_dev,
                          envs_per_device)
        mb_local = max(1, rl_cfg.mini_batch_size // n_dev)
    cap_per_dev = max(rl_cfg.replay_capacity_episodes // n_dev, envs_per_device)

    def local_generation_exp(ts, rep, key, episode_base, consts):
        """Experience-mode generation on each device (local flat shard).

        ``rep`` arrives with a leading per-device axis of length 1 (the flat
        replay's scalar counters — cursor, n_episodes — are device-varying
        under early termination, so EVERY leaf is stacked on a sharded
        leading axis rather than mixing sharded buffers with replicated
        scalars); squeeze it off for the local FlatReplay view."""
        from marlpde_tpu.rl import replay_flat
        rep = jax.tree.map(lambda a: a[0], rep)
        dev = jax.lax.axis_index(axis)
        k_col, k_upd = jax.random.split(jax.random.fold_in(key[0], dev))
        base = episode_base[0] + dev * envs_per_device
        traj, final = collect_episodes(env, rl_cfg, ts, k_col,
                                       envs_per_device, base, consts=consts)
        ts = vracer.observe_episodes(rl_cfg, ts, traj)
        ts = ts.replace(
            obs_stats=jax.tree.map(lambda a: jax.lax.pmean(a, axis), ts.obs_stats),
            rew_stats=jax.tree.map(lambda a: jax.lax.pmean(a, axis), ts.rew_stats))
        rep = vracer.flat_insert(rl_cfg, ts, rep, traj, axis=axis)

        ready = (jax.lax.psum(replay_flat.num_experiences(rep), axis)
                 >= rl_cfg.replay_start_experiences)
        upd_keys = jax.random.split(k_upd, updates_per_gen)

        def run_updates(operand):
            def one_update(carry, k):
                ts_c, rep_c = carry
                ts2, rep2, _m = vracer.update_experience(
                    rl_cfg, ts_c, rep_c, k, axis=axis, mini_batch=mb_local)
                return (ts2, rep2), None
            return jax.lax.scan(one_update, operand, upd_keys)[0]

        ts, rep = jax.lax.cond(ready, run_updates, lambda o: o, (ts, rep))
        stats = dict(
            mean_return=jax.lax.pmean(final.cum_reward.mean(), axis),
            mean_ep_len=jax.lax.pmean(traj["mask"].sum(1).mean(), axis),
            experiences=jax.lax.psum(replay_flat.num_experiences(rep), axis))
        return ts, jax.tree.map(lambda a: a[None], rep), stats

    def local_generation(ts, rep, key, episode_base, consts):
        """Runs on each device via shard_map (inputs are local shards)."""
        dev = jax.lax.axis_index(axis)
        k_col, k_upd = jax.random.split(jax.random.fold_in(key[0], dev))
        base = episode_base[0] + dev * envs_per_device
        traj, final = collect_episodes(env, rl_cfg, ts, k_col,
                                       envs_per_device, base, consts=consts)
        rep = replay_mod.add_episodes(rep, traj)
        ts = vracer.observe_episodes(rl_cfg, ts, traj)
        # keep normalizer stats identical across devices
        ts = ts.replace(
            obs_stats=jax.tree.map(lambda a: jax.lax.pmean(a, axis), ts.obs_stats),
            rew_stats=jax.tree.map(lambda a: jax.lax.pmean(a, axis), ts.rew_stats))

        ready = replay_mod.num_experiences(rep) * n_dev >= rl_cfg.replay_start_experiences

        def one_update(carry, k):
            ts_c = carry
            batch = replay_mod.sample_episodes(rep, k, rl_cfg.mini_batch_episodes)
            cutoff = rl_cfg.cutoff_scale / (1.0 + rl_cfg.annealing_rate *
                                            ts_c.n_updates.astype(jnp.float32))
            grads, metrics = jax.grad(
                lambda p: vracer._loss(rl_cfg, p, ts_c, batch, cutoff),
                has_aux=True)(ts_c.params)
            grads = jax.tree.map(lambda g: jax.lax.pmean(g, axis), grads)
            frac_far = jax.lax.pmean(metrics["frac_far"], axis)
            updates, opt_state = vracer.make_optimizer(rl_cfg).update(
                grads, ts_c.opt_state, ts_c.params)
            params = optax.apply_updates(ts_c.params, updates)
            nu = jnp.asarray(rl_cfg.lr * 10.0, ts_c.beta.dtype)
            beta = jnp.where(frac_far > rl_cfg.offpolicy_target,
                             (1.0 - nu) * ts_c.beta, (1.0 - nu) * ts_c.beta + nu)
            beta = jnp.clip(beta, 0.05, 1.0)
            new_ts = ts_c.replace(params=params, opt_state=opt_state, beta=beta,
                                  n_updates=ts_c.n_updates + 1)
            # no-op until the replay is warm
            new_ts = jax.tree.map(lambda n, o: jnp.where(ready, n, o), new_ts, ts_c)
            return new_ts, None

        upd_keys = jax.random.split(k_upd, updates_per_gen)
        ts, _ = jax.lax.scan(one_update, ts, upd_keys)

        stats = dict(
            mean_return=jax.lax.pmean(final.cum_reward.mean(), axis),
            mean_ep_len=jax.lax.pmean(traj["mask"].sum(1).mean(), axis),
            experiences=jax.lax.psum(replay_mod.num_experiences(rep), axis))
        return ts, rep, stats

    def make_rep():
        if exp_mode:
            # global layout: every leaf (buffers AND scalar counters) stacked
            # on a leading n_dev axis sharded over `axis` — each device owns
            # one FlatReplay shard of flat_cap experiences
            from marlpde_tpu.rl import replay_flat
            local = replay_flat.init_flat(flat_cap, flat_ep_cap,
                                          env.num_agents, env.obs_dim,
                                          env.act_dim)
            return jax.tree.map(
                lambda a: jnp.broadcast_to(a[None], (n_dev,) + a.shape), local)
        return replay_mod.init(cap_per_dev * n_dev, env.episode_length,
                               env.num_agents, env.obs_dim, env.act_dim)

    rep_spec = (jax.tree.map(lambda _: P(axis), jax.eval_shape(make_rep))
                if exp_mode else leading_specs(jax.eval_shape(make_rep), axis))
    # check_vma=False: scan carries inside mix device-varying (env states from
    # folded keys) and replicated values; the vma typecheck would require
    # manual pcasts at every scan entry for no semantic gain here.
    gen_fn = jax.jit(jax.shard_map(
        local_generation_exp if exp_mode else local_generation, mesh=mesh,
        in_specs=(P(), rep_spec, P(axis), P(axis), P()),
        out_specs=(P(), rep_spec, P()), check_vma=False))

    def init_replay_shards():
        return shard_leading(mesh, make_rep(), axis)

    return gen_fn, init_replay_shards


def run_generations(env: Env, rl_cfg, mesh: Mesh, envs_per_device: int,
                    updates_per_gen: int, n_generations: int, seed: int = 0,
                    axis: str = "env", verbose: bool = False,
                    init_ts=None, history: Optional[dict] = None,
                    testing_frequency: int = 0, testing_episodes: int = 8,
                    checkpoint_dir: Optional[str] = None,
                    checkpoint_every: int = 25, init_key=None):
    """Convenience driver used by the multi-device dry-run and `run.py --mesh`.

    Returns (ts, rep_shards, history) where history carries per-generation
    gen/experiences/mean_return/mean_ep_len (the trainer-history subset rlview
    understands).  Feature parity with trainer.train: deterministic evals
    every ``testing_frequency`` generations (korali Testing Frequency),
    periodic checkpoints (train state + history + RNG/counter meta; korali
    File Output, run-vracer-burger.py:198-201), and resume via
    ``init_ts``/``history``/``init_key``."""
    import time as _time

    n_dev = mesh.devices.size
    gen_fn, init_rep = make_sharded_generation(
        env, rl_cfg, mesh, envs_per_device, updates_per_gen, axis)
    key = init_key if init_key is not None else jax.random.key(seed)
    key, k0 = jax.random.split(key)
    ts = replicate(mesh, init_ts if init_ts is not None
                   else vracer.init_train(rl_cfg, k0))
    rep = init_rep()
    collect_det = jax.jit(lambda ts_, key_, consts: collect_episodes(
        env, rl_cfg, ts_, key_, testing_episodes, 0, deterministic=True,
        consts=consts))
    history = history if history is not None else dict(
        gen=[], experiences=[], mean_return=[], mean_ep_len=[], wall_time=[],
        test_return=[])
    history.setdefault("test_return", [])
    gen0 = history["gen"][-1] if history["gen"] else 0

    def save(gen_now):
        if not checkpoint_dir:
            return
        from marlpde_tpu.utils import checkpoint as ckpt
        ckpt.save_train_state(checkpoint_dir, jax.device_get(ts), history)
        exp_now = history["experiences"][-1] if history["experiences"] else 0
        ckpt.save_meta(checkpoint_dir, key, gen_now, exp_now,
                       gen_now * n_dev * envs_per_device, rl_cfg=rl_cfg)

    t0 = _time.time()
    for g in range(n_generations):
        key, kg = jax.random.split(key)
        keys = jax.random.split(kg, n_dev)
        bases = jnp.full((n_dev,), (gen0 + g) * n_dev * envs_per_device,
                         jnp.int32)
        ts, rep, stats = gen_fn(ts, rep, keys, bases, env.consts)
        gen_now = gen0 + g + 1
        history["gen"].append(gen_now)
        history["experiences"].append(
            gen_now * n_dev * envs_per_device * env.episode_length)
        history["mean_return"].append(float(stats["mean_return"]))
        history["mean_ep_len"].append(float(stats["mean_ep_len"]))
        history["wall_time"].append(_time.time() - t0)
        if testing_frequency and gen_now % testing_frequency == 0:
            key, k_t = jax.random.split(key)
            _ttraj, tfinal = collect_det(ts, k_t, env.consts)
            history["test_return"].append(float(tfinal.cum_reward.mean()))
        if checkpoint_dir and gen_now % checkpoint_every == 0:
            save(gen_now)
        if verbose:
            print(f"[mesh-trainer] gen {gen_now} devices {n_dev} "
                  f"return {history['mean_return'][-1]:.5f} "
                  f"eplen {history['mean_ep_len'][-1]:.1f}", flush=True)
    save(gen0 + n_generations)
    return ts, rep, history
