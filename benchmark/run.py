"""Run one cell of the benchmark of `mj_envs_torch` on this machine's
cards and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  `--trace 0` reports the cell's end-to-end
metrics, `--trace 1` its per-layer metrics (spans, counters and one
profiled slice), each with `correct` decided against the plain reference.
Without the cards the cell asks for, or with a module of JAX or of the
JAX package loaded once the window has closed, it exits non-zero and
prints no result.  The numbers compared are printed beside their limits
as the last lines of standard error and under `checked` in the result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT
else:
    sys.path.insert(0, ROOT)

# Top-level modules the measured process may not hold (compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mj_envs_tpu")


def loaded_forbidden():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        from benchmark.lib import harness
    except ImportError as e:
        print(f"cannot load the harness or the port: {e}", file=sys.stderr)
        return 2
    print(f"# card (nvidia-smi name, power.limit): {card_line()}",
          flush=True)
    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START)
    except harness.NoDevice as e:
        print(str(e), file=sys.stderr)
        return 2
    bad = loaded_forbidden()
    if bad:
        print("modules of JAX or of the JAX package loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checked"].items():
        print(f"checked {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
