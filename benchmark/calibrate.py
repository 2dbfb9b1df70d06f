"""Readings from which the check's limits are set, on the card, for one
cell at its own size (not run by the benchmark's own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 [--first 0]
        [--units 1] [--fault unchanged|half_batch|altered|merge] [--no-control]

For each seed, in one process: the cell's set-up (warm-up unit included)
and `--units` more units at the cell's load, then the check's numbers
for the program and for the control: the reference in float32 with TF32
matrix products in the program's place.  The check is the one a run
builds: a rollout cell's at its fixed unit (`check_at`, stepped on to
where `--units` stops short of it), a PPO cell's at the last unit.  With
`--fault` the program runs with that fault planted (`lib/faults.py`),
up to the check's last unit.  One JSON line per seed, then a summary:
for each number the program's largest reading and the control's
smallest.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=0)
    p.add_argument("--units", type=int, default=1)
    p.add_argument("--fault", default=None)
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import contextlib
    import torch
    from benchmark.lib import drive, faults, spec

    cell = spec.Cell(args.workload)
    dev = torch.device(args.device)
    drive.apply_options(cell.config)
    kind = spec.kind(cell.traffic["kind"])
    prog, ctrl = {}, {}
    for seed in range(args.first, args.first + args.seeds):
        t0 = time.perf_counter()
        fault = faults.planted(args.fault, cell.traffic["kind"]) \
            if args.fault \
            else contextlib.nullcontext()
        with fault:
            d = kind.Drive(cell.config, cell.traffic, seed, dev, cell.limits)
            d.setup()
            d.mark()
            try:
                for _ in range(args.units):
                    d.unit()
            finally:
                d.close()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            # inside the fault: a rollout check steps on to its unit
            chk = kind.Check(d, cell, seed)
        del d
        t1 = time.perf_counter()
        line = {"seed": seed, "program": chk.numbers(dev)}
        t2 = time.perf_counter()
        if not args.no_control:
            line["control"] = chk.numbers(dev, control=True)
        line["seconds"] = dict(run=t1 - t0, reference=t2 - t1,
                               control=time.perf_counter() - t2)
        print(json.dumps(line), flush=True)
        for k, v in line["program"].items():
            prog[k] = max(prog.get(k, 0.0), v)
        for k, v in line.get("control", {}).items():
            ctrl[k] = min(ctrl.get(k, float("inf")), v)
    print(json.dumps({"summary": args.workload, "fault": args.fault,
                      "program_max": prog, "control_min": ctrl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
