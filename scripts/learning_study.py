"""VRACER acceptance study: learning curves on diffusion-simple (SURVEY §7).

The reference's RL engine is korali (C++, not installable here); SURVEY §7
names the acceptance test for the re-implemented VRACER as *learning-curve
parity on diffusion-simple* rather than bitwise equality.  This study runs the
reference driver configuration (run-vracer-diffusion-simple.py:5-21,76-79:
N=128, 1 agent, dt=0.01, nu=0.1, noise=0.5, sinus IC, episodeLength=500,
width=128, iex=3, lr=1e-4, gamma=0.95, mini-batch 256, 1 experience between
policy updates) for both minibatch samplers (whole-episode mode and
korali's 256-uniform-experience mode) over multiple seeds, and records:

  - the stochastic training return per generation,
  - deterministic test returns every `testfreq` generations
    (korali Testing Frequency, run-vracer-diffusion-simple.py:17),
  - the final deterministic return vs the untrained-policy baseline.

Acceptance (what korali's VRACER achieves on this workload): the deterministic
policy drives the per-step MSE-vs-analytical reward to ~0 (the agent recovers
the exact FD stencil) well inside the reference's 1e6-experience budget.  The
committed artifact lives in results/learning_r2/.

Usage:
  python scripts/learning_study.py \
      --ne 150000 --seeds 3 --out results/learning_r2
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_one(mode: str, seed: int, ne: float, numenvs: int, eplen: int,
            testfreq: int):
    import jax

    from marlpde_tpu.envs import registry
    from marlpde_tpu.rl import vracer
    from marlpde_tpu.train import trainer

    env = registry.make_env(
        "diffusion-simple", N=128, num_agents=1, dt=0.01, nu=0.1,
        episode_length=eplen, ic_case="sinus", noise=0.5)
    rl_cfg = trainer.default_rl_config(
        env, width=128, gamma=0.95, lr=1e-4, init_noise=3.0,
        minibatch_mode=mode, mini_batch_size=256,
        experiences_between_updates=1.0,
        # korali ER sizes for the diffusion drivers (Start 32768, Max 2^20,
        # run-vracer-diffusion-simple.py:73-74)
        replay_start_experiences=32768, replay_max_experiences=2**20)
    # korali-faithful accounting: episodes early-stop after ~10-20 live steps
    # (cumreward<0), and korali counts/updates on REAL experiences
    tc = trainer.TrainerConfig(
        num_envs=numenvs, max_experiences=ne, reuse_ratio=256.0,
        max_updates_per_gen=500, seed=seed, count_real_experiences=True,
        testing_frequency=testfreq, testing_episodes=10)

    ts, _, hist = trainer.train(env, rl_cfg, tc, verbose=True)
    final = trainer.evaluate(env, rl_cfg, ts, jax.random.key(seed + 1000),
                             n_episodes=10)
    ts0 = vracer.init_train(rl_cfg, jax.random.key(seed + 77))
    untrained = trainer.evaluate(env, rl_cfg, ts0, jax.random.key(seed + 2000),
                                 n_episodes=10)
    return {
        "mode": mode, "seed": seed,
        "experiences": [int(e) for e in hist["experiences"]],
        "mean_return": [float(r) for r in hist["mean_return"]],
        "test_return": [float(r) for r in hist["test_return"]],
        "testfreq_gens": testfreq,
        "final_deterministic_return": float(np.mean(np.asarray(final))),
        "untrained_deterministic_return": float(np.mean(np.asarray(untrained))),
    }


def plot(runs, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(1, 2, figsize=(11, 4), sharey=True)
    styles = {"episode": dict(color="tab:blue"),
              "experience": dict(color="tab:orange")}
    for ax, key, title in ((axs[0], "mean_return",
                            "stochastic training return"),
                           (axs[1], "test_return",
                            "deterministic test return")):
        for r in runs:
            exp = np.asarray(r["experiences"], float)
            if key == "test_return":
                tf = r["testfreq_gens"]
                x = exp[tf - 1::tf][:len(r[key])]
                y = np.asarray(r[key], float)
            else:
                x, y = exp, np.asarray(r[key], float)
            ax.plot(x, -y, lw=1.2, alpha=0.8, **styles[r["mode"]])
        ax.set_yscale("log")
        ax.set_xlabel("experiences")
        ax.set_title(title)
        ax.grid(alpha=0.3)
    axs[0].set_ylabel("-return  (cumulative MSE vs analytical, log)")
    for m, st in styles.items():
        axs[0].plot([], [], label=f"sampler={m}", **st)
    axs[0].legend()
    fig.suptitle("VRACER on diffusion-simple (reference config, "
                 "run-vracer-diffusion-simple.py) — 3 seeds x 2 samplers")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ne", type=float, default=150000.0)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--numenvs", type=int, default=10)   # Episodes Per Generation
    ap.add_argument("--episodelength", type=int, default=500)
    ap.add_argument("--testfreq", type=int, default=5)
    ap.add_argument("--out", type=str, default="results/learning_r2")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    runs = []
    for mode in ("episode", "experience"):
        for seed in range(args.seeds):
            print(f"[study] mode={mode} seed={seed}", flush=True)
            runs.append(run_one(mode, seed, args.ne, args.numenvs,
                                args.episodelength, args.testfreq))
            print(json.dumps({k: runs[-1][k] for k in
                              ("mode", "seed", "final_deterministic_return",
                               "untrained_deterministic_return")}), flush=True)

    summary = {
        "workload": "diffusion-simple (reference config: N=128, 1 agent, "
                    "dt=0.01, nu=0.1, noise=0.5, eplen=500, width=128, iex=3, "
                    "lr=1e-4, gamma=0.95, mb=256, expperu=1)",
        "acceptance": "deterministic return -> ~0 (agent recovers the exact "
                      "FD stencil) within a fraction of the reference's 1e6-"
                      "experience budget (SURVEY §7 VRACER acceptance test)",
        "runs": runs,
        "final_by_mode": {
            m: {
                "final_deterministic_return_mean": float(np.mean(
                    [r["final_deterministic_return"] for r in runs
                     if r["mode"] == m])),
                "untrained_deterministic_return_mean": float(np.mean(
                    [r["untrained_deterministic_return"] for r in runs
                     if r["mode"] == m])),
            } for m in ("episode", "experience")},
    }
    with open(os.path.join(args.out, "diffusion_simple_study.json"), "w") as f:
        json.dump(summary, f, indent=1)
    plot(runs, os.path.join(args.out, "diffusion_simple_study.png"))
    print(json.dumps(summary["final_by_mode"], indent=1))


if __name__ == "__main__":
    sys.exit(main())
