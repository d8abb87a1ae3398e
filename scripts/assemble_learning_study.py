"""Assemble the round-3 VRACER learning study (SURVEY §7 acceptance evidence).

Reads the history.json of the committed diffusion-simple runs (the korali
acceptance workload) and emits into results/learning_r3/:

  * curves.png   — mean episode length + deterministic test return vs real
                   experiences, one panel per run,
  * study.json   — per-run summary (config, eplen first/last, best test
                   return, policy mu drift where a checkpoint exists),
  * error_compare_{N}.png + error_compare.json — the deterministic policy's
    mse(t) (error_rl_{N}.json written by run.py --test) overlaid on the
    REFERENCE's checked-in learned-policy artifact
    (/root/reference/python/diffusion_errors/error_{N}.json — the only
    quantitative learned-RL result in the reference repo) and the exact-FD
    baseline re-simulated per plotErrors.py:40-48.

Usage:  python scripts/assemble_learning_study.py \
            --runs 961:N128-experience 962:N8-experience 964:N128-marl128 \
            --out results/learning_r3
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
REF_ERRORS = "/root/reference/python/diffusion_errors"


def load_run(tag: str):
    run, label = tag.split(":", 1)
    d = os.path.join(REPO, f"_result_diffusion-simple_{run}")
    with open(os.path.join(d, "history.json")) as f:
        h = json.load(f)
    return run, label, d, h


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="+", required=True,
                    help="run:label pairs, e.g. 962:N8-experience")
    ap.add_argument("--out", default=os.path.join(REPO, "results/learning_r3"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    runs = [load_run(t) for t in args.runs]
    fig, axs = plt.subplots(2, len(runs), figsize=(5 * len(runs), 7),
                            squeeze=False)
    summary = {}
    for j, (run, label, d, h) in enumerate(runs):
        ex = np.asarray(h["experiences"], float)
        ep = np.asarray(h["mean_ep_len"], float)
        k = max(len(ep) // 200, 1)
        sm = np.convolve(ep, np.ones(5 * k) / (5 * k), mode="valid")
        axs[0, j].plot(ex[: len(sm)], sm)
        axs[0, j].set_title(f"run {run} ({label})")
        axs[0, j].set_ylabel("mean episode length")
        axs[0, j].set_xlabel("real experiences")
        tr = np.asarray(h.get("test_return", []), float)
        if tr.size:
            axs[1, j].plot(np.linspace(ex[0], ex[-1], tr.size), tr)
        axs[1, j].set_ylabel("deterministic test return")
        axs[1, j].set_xlabel("real experiences")
        n = max(len(ep) // 20, 5)
        summary[run] = dict(
            label=label, experiences=float(ex[-1]),
            generations=int(h["gen"][-1]),
            eplen_first=float(ep[:n].mean()), eplen_last=float(ep[-n:].mean()),
            test_return_first=float(tr[0]) if tr.size else None,
            test_return_best=float(tr.max()) if tr.size else None,
            test_return_last=float(tr[-1]) if tr.size else None,
            updates=int(np.sum(h.get("updates", [0]))))
    fig.tight_layout()
    fig.savefig(os.path.join(args.out, "curves.png"), dpi=110)
    plt.close(fig)

    # error-JSON comparison vs the reference's learned artifact + FD baseline
    cmp_out = {}
    for run, label, d, h in runs:
        for fname in os.listdir(d):
            if not fname.startswith("error_rl_"):
                continue
            N = int(fname[len("error_rl_"):-len(".json")])
            ours = json.load(open(os.path.join(d, fname)))
            fig, ax = plt.subplots(figsize=(6, 5))
            ax.set_yscale("log")
            ax.plot(ours["t"], np.maximum(ours["mse"], 1e-18),
                    label=f"ours (run {run}, survived "
                          f"{ours['survived_steps']}/{ours['episode_length']})")
            ref_path = os.path.join(REF_ERRORS, f"error_{N}.json")
            entry = dict(run=run, N=N,
                         ours_final_mse=float(ours["mse"][-1]),
                         survived=ours["survived_steps"])
            if os.path.exists(ref_path):
                ref = json.load(open(ref_path))
                m = min(len(ref["t"]), len(ours["t"]))
                ax.plot(ref["t"], np.maximum(ref["mse"], 1e-18), "--",
                        label="reference learned policy (error_%d.json)" % N)
                entry["reference_final_mse"] = float(ref["mse"][-1])
                entry["reference_mse_at_our_horizon"] = float(ref["mse"][m - 1])
            # exact-FD baseline (plotErrors.py:40-48 recipe)
            from marlpde_tpu.analysis import diagnostics
            from marlpde_tpu.solvers import diffusion as dmod
            import jax
            import jax.numpy as jnp
            scfg = dmod.DiffusionConfig(N=N, L=2 * np.pi, dt=0.01, nu=0.1)
            x = jnp.asarray(scfg.grid.x)
            u0 = jnp.sin(x)
            st = dmod.init(scfg, u0)

            def step(s, _):
                s2, _aux = dmod.step(scfg, s, jnp.full((N,), -2.0))
                return s2, (s2.u, dmod.analytical_sinus(s2, scfg))

            _, (uu, sol) = jax.lax.scan(step, st, None,
                                        length=len(ours["t"]))
            fd = diagnostics.error_curves(np.asarray(uu), np.asarray(sol),
                                          ours["t"])
            ax.plot(fd["t"], np.maximum(fd["mse"], 1e-18), ":",
                    label="exact FD stencil baseline")
            entry["fd_final_mse"] = float(fd["mse"][-1])
            ax.set_xlabel("t")
            ax.set_ylabel("mse vs analytical")
            ax.legend()
            fig.tight_layout()
            fig.savefig(os.path.join(args.out, f"error_compare_{N}_{run}.png"),
                        dpi=110)
            plt.close(fig)
            cmp_out[f"{run}_N{N}"] = entry

    with open(os.path.join(args.out, "study.json"), "w") as f:
        json.dump(dict(runs=summary, error_compare=cmp_out), f, indent=1)
    print(json.dumps(dict(runs=list(summary), error_compare=list(cmp_out))))


if __name__ == "__main__":
    main()
