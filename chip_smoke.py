#!/usr/bin/env python3
"""GPU smoke test of the flagship Burgers-MARL training path.

    python chip_smoke.py               # one GPU: device, train, reference, kernels
    python chip_smoke.py --devices 4   # four GPUs: the mesh training path only

Phases (one process; it is the only one that opens the card):

  device     refuse anything but a GPU backend; print the card's name and
             power limit (nvidia-smi), JAX and CUDA versions
  train      `marlpde_tpu.run.main` on the flagship command
             (burger-marl --specreward --dforce --fused --ic turbulence:
             N_dns=512, LES N=32, 32 actions, 32 agents, episode length 500,
             nIntermediate=10, policy width 256) for 3 generations; asserts
             finite returns, updates taken, a checkpoint written
  reference  the fast step (plain XLA and the Pallas kernel) and a KS LES
             against float64 numpy re-derivations, each worst error beside
             its limit (marlpde_tpu/analysis/chip_checks.py)
  kernels    Pallas macro-step kernel against the plain XLA step, per
             macro-step and per fused training generation; the acting
             policy forward at the flagship rows

With --devices 4 only the mesh path runs (`run.py --mesh`): 3 generations on
4 GPUs at the flagship widths with the distributed invariants, then a short
run compared with the same sharded program on 4 CPU devices.

The last line of stdout is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Any failed phase exits non-zero before printing it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

FLAGSHIP = ["burger-marl", "--specreward", "--dforce", "--fused",
            "--ic", "turbulence"]
# batch sizes of the reference and kernel phases and of the mesh run
REF_BATCHES = (1024, 4096)
GEN_ENVS = 1024
GEN_PAIRS = 10      # timed (auto, pallas) generation pairs, order alternating
KS_ENVS = 64
MESH_ENVS_PER_DEVICE = 64


def log(msg):
    print(msg, flush=True)


def require_gpu(jax):
    """Fail unless JAX's default backend is a GPU."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU backend, JAX has "
                         f"'{backend}'")
    return jax.devices()


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def phase_device(jax):
    devs = require_gpu(jax)
    log(nvidia_smi())           # name and power limit, one line per card
    info = jax.print_environment_info(return_string=True)
    versions = [ln.strip() for ln in info.splitlines()
                if ln.startswith(("jax:", "jaxlib:")) or "CUDA Version" in ln]
    log(f"[device] {' | '.join(versions)}")
    log(f"[device] {len(devs)} x {devs[0].device_kind}")
    return devs


def phase_train(numenvs: int, gens: int):
    import jax
    import numpy as np
    from marlpde_tpu import run
    compile_s = []
    jax.monitoring.register_event_duration_secs_listener(
        lambda ev, d, **kw: compile_s.append(d)
        if ev == "/jax/core/compile/backend_compile_duration" else None)
    tag = 990
    result_dir = f"_result_burger-marl_{tag}"
    shutil.rmtree(result_dir, ignore_errors=True)
    T = run.build_parser().parse_args(FLAGSHIP).episodelength
    argv = FLAGSHIP + ["--numenvs", str(numenvs),
                       "--NE", str(numenvs * T * gens),
                       "--testfreq", "0", "--run", str(tag)]
    log(f"[train] python -m marlpde_tpu.run {' '.join(argv)}")
    t0 = time.perf_counter()
    run.main(argv)
    wall = time.perf_counter() - t0
    with open(os.path.join(result_dir, "history.json")) as f:
        hist = json.load(f)
    rets = hist["mean_return"]
    cum = [0.0] + hist["wall_time"]
    per_gen = [b - a for a, b in zip(cum, cum[1:])]
    log(f"[train] {len(rets)} generations of {numenvs} episodes: returns "
        f"{rets}, updates {hist['updates']}")
    log(f"[train] backend compile {sum(compile_s):.1f} s "
        f"({len(compile_s)} programs); per-generation seconds "
        f"{[round(t, 3) for t in per_gen]} (generation 1 includes compile); "
        f"main() wall {wall:.1f} s")
    ok = (len(rets) == gens and bool(np.all(np.isfinite(rets)))
          and sum(hist["updates"]) > 0
          and os.path.exists(os.path.join(result_dir, "latest.pkl")))
    log(f"[train] finite returns, updates taken, checkpoint written: "
        f"{'PASS' if ok else 'FAIL'}")
    return ok


def flagship_workload(numenvs: int):
    from marlpde_tpu import run
    args = run.build_parser().parse_args(FLAGSHIP + ["--numenvs",
                                                     str(numenvs)])
    return run.make_workload(args)


def phase_reference():
    from marlpde_tpu import run
    from marlpde_tpu.analysis import chip_checks as cc
    env, _, _ = flagship_workload(GEN_ENVS)
    B0 = REF_BATCHES[0]
    results = [cc.fast_step_vs_float64(env, B=B0)]
    results += [cc.fast_step_vs_float64(env, B=B, use_pallas=True)
                for B in REF_BATCHES]
    ks_args = run.build_parser().parse_args(["ks", "--ndns", "4"])
    ks_env, _, _ = run.make_workload(ks_args)
    results.append(cc.ks_les_vs_float64(ks_env, B=KS_ENVS, n_macro=50))
    for r in results:
        log(cc.format_result(r))
    return all(r["ok"] for r in results)


def phase_kernels():
    import numpy as np
    from marlpde_tpu.analysis import chip_checks as cc
    from marlpde_tpu.envs import registry
    env, rl_cfg, tc = flagship_workload(GEN_ENVS)
    for B in REF_BATCHES:
        t_x = cc.time_macro_steps(env, B, use_pallas=False)
        t_p = cc.time_macro_steps(env, B, use_pallas=True)
        log(f"[kernels] macro-step B={B} ({env.cfg.n_intermediate} sub-steps, "
            f"no policy): plain XLA {t_x * 1e3:.4f} ms, pallas kernel "
            f"{t_p * 1e3:.4f} ms, ratio {t_x / t_p:.3f}")
    env_p = registry.make_env("burger", cfg=env.cfg, pool=env.consts,
                              fast="pallas")
    runs = {}
    for name, e in (("auto", env), ("pallas", env_p)):
        first, timed = cc.generation_timer(e, rl_cfg, tc)
        runs[name] = (first, timed)
        log(f"[kernels] fused generation --fast {name}: compile+first "
            f"{first:.2f} s")
    times = {"auto": [], "pallas": []}
    for i in range(GEN_PAIRS):
        for name in (("auto", "pallas") if i % 2 == 0 else ("pallas", "auto")):
            t, stats = runs[name][1]()
            times[name].append(t)
    wins = sum(p < a for a, p in zip(times["auto"], times["pallas"]))
    log(f"[kernels] fused generation ({tc.num_envs} episodes x "
        f"{env.episode_length} macro-steps + {stats['n_upd']} updates), "
        f"{GEN_PAIRS} pairs in alternating order: --fast auto "
        f"{[round(t, 4) for t in times['auto']]} s, --fast pallas "
        f"{[round(t, 4) for t in times['pallas']]} s; median auto "
        f"{np.median(times['auto']):.4f} s, pallas "
        f"{np.median(times['pallas']):.4f} s; pallas faster in {wins}/"
        f"{GEN_PAIRS} pairs")
    rows = tc.num_envs * env.num_agents
    t_pol = cc.time_policy_forward(rl_cfg, rows)
    log(f"[kernels] acting policy forward, {rows} rows x width "
        f"{rl_cfg.width}: {t_pol * 1e3:.4f} ms")
    return True


def phase_mesh(n: int):
    import jax
    from marlpde_tpu.analysis import chip_checks as cc
    from marlpde_tpu.train import trainer
    import __graft_entry__ as graft
    gpus = jax.devices()
    if len(gpus) < n:
        raise SystemExit(f"chip_smoke: --devices {n} needs {n} GPUs, "
                         f"have {len(gpus)}")
    per_dev = MESH_ENVS_PER_DEVICE
    env, rl_cfg, _ = flagship_workload(per_dev * n)
    t0 = time.perf_counter()
    ts, rep, hist = cc.mesh_run(env, rl_cfg, gpus[:n],
                                envs_per_device=per_dev, updates_per_gen=50,
                                n_generations=3)
    ok, msg = cc.mesh_invariants(ts, rep, n)
    cum = [0.0] + hist["wall_time"]
    per_gen = [round(b - a, 3) for a, b in zip(cum, cum[1:])]
    log(f"[mesh] flagship widths, {per_dev * n} episodes/generation, returns "
        f"{hist['mean_return']}, per-generation seconds {per_gen} "
        f"(generation 1 includes compile), total "
        f"{time.perf_counter() - t0:.1f} s")
    log(msg)
    small_env, _ = graft._flagship(small=True)
    small_cfg = trainer.default_rl_config(
        small_env, width=16, replay_start_experiences=n,
        replay_max_experiences=n * 200, minibatch_mode="experience",
        mini_batch_size=16)
    r = cc.mesh_vs_other_devices(small_env, small_cfg, gpus[:n],
                                 jax.devices("cpu")[:n], envs_per_device=2,
                                 updates_per_gen=2)
    log(cc.format_result(r))
    return ok and r["ok"]


def main(argv=None):
    p = argparse.ArgumentParser(prog="chip_smoke.py")
    p.add_argument("--devices", type=int, default=1, choices=[1, 4],
                   help="4 runs the mesh path only, on four GPUs")
    p.add_argument("--numenvs", type=int, default=256,
                   help="episodes per training generation (train phase)")
    args = p.parse_args(argv)
    if args.devices > 1:
        # CPU devices for the mesh comparison; must precede JAX's start-up
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                                   f"--xla_force_host_platform_device_count="
                                   f"{args.devices}").strip()
    import jax
    from marlpde_tpu.utils import compile_cache
    log(f"[device] compile cache {compile_cache.setup()}")
    devs = phase_device(jax)
    if args.devices > 1:
        phases = [("mesh", lambda: phase_mesh(args.devices))]
    else:
        phases = [("train", lambda: phase_train(args.numenvs, 3)),
                  ("reference", phase_reference),
                  ("kernels", phase_kernels)]
    for name, fn in phases:
        t0 = time.perf_counter()
        ok = fn()
        log(f"[{name}] phase {'ok' if ok else 'FAILED'} in "
            f"{time.perf_counter() - t0:.1f} s")
        if not ok:
            sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
