#!/usr/bin/env python3
"""Scaling-efficiency benchmark over a device mesh.

Runs the sharded generation (env shards + DP learner, parallel/mesh.py) on
1, 2, ..., N devices and reports throughput scaling efficiency —
the BASELINE.md ">=80% scaling at 1 chip / 1 host / N hosts" harness.

On several GPUs this measures real scaling; on CPU it validates the
mechanism with a virtual mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python scripts/bench_scaling.py --envs-per-device 8

Prints one JSON line per mesh size plus a summary line.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--envs-per-device", type=int, default=8)
    p.add_argument("--episode-length", type=int, default=20)
    p.add_argument("--updates-per-gen", type=int, default=4)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    args = p.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from marlpde_tpu.envs import registry
    from marlpde_tpu.parallel import mesh as pmesh
    from marlpde_tpu.train import trainer

    devs = jax.devices()
    env = registry.make_env(
        "burger", N_dns=128, grid_size=32, num_actions=32, num_agents=4,
        dt=0.01, T=args.episode_length * 0.01, nu=0.02,
        episode_length=args.episode_length, ic_case="turbulence",
        spectral_reward=True, noise=0.0, dtype=jnp.float32)
    rl_cfg = trainer.default_rl_config(
        env, width=32, replay_start_experiences=1,
        replay_max_experiences=args.envs_per_device * len(devs)
        * args.episode_length * 8, mini_batch_episodes=2)

    sizes = []
    n = 1
    while n <= len(devs):
        sizes.append(n)
        n *= 2
    if sizes[-1] != len(devs):
        sizes.append(len(devs))

    results = {}
    for nd in sizes:
        mesh = pmesh.make_mesh(devs[:nd])
        gen_fn, init_rep = pmesh.make_sharded_generation(
            env, rl_cfg, mesh, args.envs_per_device, args.updates_per_gen)
        rep = init_rep()
        key = jax.random.key(0)
        ts = pmesh.replicate(mesh, __import__(
            "marlpde_tpu.rl.vracer", fromlist=["vracer"]).init_train(
                rl_cfg, key))
        keys = jax.random.split(key, nd)
        bases = jnp.zeros((nd,), jnp.int32)
        # warm
        ts, rep, stats = gen_fn(ts, rep, keys, bases, env.consts)
        _ = float(stats["mean_return"])   # D2H barrier
        times = []
        for i in range(args.reps):
            t0 = time.perf_counter()
            ts, rep, stats = gen_fn(ts, rep, keys, bases, env.consts)
            _ = float(stats["mean_return"])
            times.append(time.perf_counter() - t0)
        dt = sorted(times)[len(times) // 2]
        steps = nd * args.envs_per_device * args.episode_length * env.cfg.n_intermediate
        results[nd] = steps / dt
        print(json.dumps({"devices": nd, "env_steps_per_s": round(results[nd], 1),
                          "per_device": round(results[nd] / nd, 1)}))

    base = results[sizes[0]]
    summary = {str(nd): round(results[nd] / (base * nd), 3) for nd in sizes}
    print(json.dumps({"metric": "scaling_efficiency_vs_1dev", **summary}))


if __name__ == "__main__":
    main()
