#!/usr/bin/env python3
"""SLURM sbatch generator/submitter — the jobs/sbatch-*.sh equivalent
(jobs/sbatch-diffusion.sh:31-43): emits one sbatch file per (workload, run)
pair, staging results under $SCRATCH when set, and submits unless --dry.

GPU multi-node variant: with --multi-node, every node gets --gpus-per-node
GPUs and `srun` starts one process per node, which jax.distributed joins from
the SLURM environment (parallel/mesh.initialize_distributed); pass
--extra=--mesh to train over all of them.
"""

import argparse
import os
import subprocess

TEMPLATE = """#!/bin/bash -l
#SBATCH --job-name="{name}"
#SBATCH --output={name}_%j.out
#SBATCH --error={name}_%j.err
#SBATCH --time={hours}:00:00
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node=1
#SBATCH --cpus-per-task={cpus}
{gpus}
export SCRATCH=${{SCRATCH:-$PWD}}
RUNDIR=$SCRATCH/marlpde_tpu_runs/{name}
mkdir -p $RUNDIR
cd $RUNDIR

{launch} python -m marlpde_tpu.run {workload} --run {run} {extra}
"""


def main():
    p = argparse.ArgumentParser()
    p.add_argument("workload")
    p.add_argument("--runs", type=int, nargs="+", default=[0])
    p.add_argument("--hours", type=int, default=24)
    p.add_argument("--nodes", type=int, default=1)
    p.add_argument("--cpus", type=int, default=12)
    p.add_argument("--multi-node", action="store_true")
    p.add_argument("--gpus-per-node", type=int, default=0)
    p.add_argument("--extra", type=str, default="")
    p.add_argument("--dry", action="store_true")
    args = p.parse_args()

    launch = "srun" if args.multi_node else ""
    gpus = (f"#SBATCH --gpus-per-node={args.gpus_per_node}\n"
            if args.gpus_per_node else "")
    for run in args.runs:
        name = f"{args.workload}_{run}"
        script = TEMPLATE.format(name=name, hours=args.hours, nodes=args.nodes,
                                 cpus=args.cpus, gpus=gpus,
                                 workload=args.workload,
                                 run=run, extra=args.extra, launch=launch)
        fname = f"sbatch_{name}.sh"
        with open(fname, "w") as f:
            f.write(script)
        print(f"wrote {fname}")
        if not args.dry:
            subprocess.run(["sbatch", fname], check=False)


if __name__ == "__main__":
    main()
