#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port (`mj_envs_torch`): hammer-v0
env-steps/s on one NVIDIA GPU at 4096 envs, stepped in 512-env chunks,
float32, uniform random actions in [-1, 1), with auto-reset.

Run from the root of a checkout:  python3 bench_torch.py

Prints headline JSON lines {"metric", "value", "unit", "vs_baseline"} as
sizes complete, the north-star size last; before each, the child's own
JSON line with everything behind it.

* `value` is the **median** env-steps/s of 5 timed repeats of
  BENCH_STEPS steps each (default 2), after one warm-up
  reset and step that includes the kernels' build.  Each repeat is timed
  on the host clock and ends in `torch.cuda.synchronize()`.  The child
  line carries every repeat's rate, their min and max, the steps per
  repeat, the chunk, the card's name and power limit (nvidia-smi), and
  every kernel's launches over the timed repeats.
* After the repeats, one untimed auto-reset step at the same size is
  instrumented: the card is synchronized around each part of
  `AdroitEnv._step_auto_reset_pair` (the FRAME_SKIP physics substeps,
  obs plus reward, the reset, and the merge of the fresh and stepped
  states), and the child line gives each part in ms per env step and as
  a share of the step.  The timing wrappers sit on that env object for
  that step only.
* `vs_baseline` divides by the live baseline: single-env `mujoco` (C,
  one core) stepping the port's sanitized hammer scene at frame_skip 5.
  Without `mujoco` it is -1.0 and the child line says why.

Processes (as `bench.py`): the parent probes the device in a child with
a timeout (BENCH_PROBE_TIMEOUT, default 300 s), then measures each size
of BENCH_SIZES (default "4096,1024") in its own child (`--child N`)
with a timeout sized to what is left of BENCH_DEADLINE (default 1500 s).
BENCH_CHUNK sets the chunk (default 512 at 2048 envs and above, else
one chunk), BENCH_NORTH_STAR the size printed last (default 4096).

There is no CPU rung: without a CUDA device the parent prints a FAILED
line with the error and exits non-zero.  A size that crashes on the card
retries smaller sizes on the card, each named in its line.  `--child N
--device cpu` measures the plain CPU path (what a CPU test runs).
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MEASURE_STEPS = int(os.environ.get("BENCH_STEPS", 2))
REPEATS = 5     # an odd count: the median is one of the repeats
DEADLINE_S = float(os.environ.get("BENCH_DEADLINE", 1500))
NORTH_STAR = int(os.environ.get("BENCH_NORTH_STAR", 4096))
TASK = "hammer-v0"
FRAME_SKIP_BASELINE = 5
_T0 = time.time()


def gpu_info() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def baseline_steps_per_s():
    """(env-steps/s, None) of single-env mujoco on the sanitized hammer
    scene at frame_skip 5 with uniform random controls for about 1 s, or
    (nan, why) where it cannot run."""
    try:
        import mujoco
        import numpy as np
        from mj_envs_torch.mjcf import oracle
        mm = oracle.load("hammer")
    except Exception as e:   # no mujoco on the machine, or no scene
        return float("nan"), f"{type(e).__name__}: {e}"
    md = mujoco.MjData(mm)
    mujoco.mj_forward(mm, md)
    rng = np.random.default_rng(0)
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        md.ctrl[:] = rng.uniform(-1, 1, mm.nu)
        for _ in range(FRAME_SKIP_BASELINE):
            mujoco.mj_step(mm, md)
        n += 1
    return n / (time.perf_counter() - t0), None


class _Parts:
    """Synchronized timers around the parts of one auto-reset step,
    installed on one env object and removed again."""

    def __init__(self, env, sync):
        self.env, self.sync = env, sync
        self.ms = dict.fromkeys(("obs_reward", "step", "reset", "total"),
                                0.0)
        self.in_step = False

    def _timed(self, key, fn):
        def wrapper(*a, **kw):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.sync()
            self.ms[key] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    def __enter__(self):
        env = self.env
        step, reset = env.step, env.reset
        obs, reward_done = env._obs, env._reward_done
        pair = env._step_auto_reset_pair

        def in_step(fn):
            def wrapper(*a, **kw):
                self.in_step = True
                try:
                    return fn(*a, **kw)
                finally:
                    self.in_step = False
            return wrapper

        def obs_part(fn):
            timed = self._timed("obs_reward", fn)
            return lambda *a, **kw: (timed if self.in_step else fn)(*a, **kw)

        env.step = self._timed("step", in_step(step))
        env.reset = self._timed("reset", reset)
        env._obs = obs_part(obs)
        env._reward_done = obs_part(reward_done)
        env._step_auto_reset_pair = self._timed("total", pair)
        return self

    def __exit__(self, *exc):
        for name in ("step", "reset", "_obs", "_reward_done",
                     "_step_auto_reset_pair"):
            del self.env.__dict__[name]

    def result(self):
        ms = self.ms
        parts = {"physics": ms["step"] - ms["obs_reward"],
                 "obs_reward": ms["obs_reward"], "reset": ms["reset"],
                 "merge": ms["total"] - ms["step"] - ms["reset"]}
        return {"ms_per_env_step": parts, "step_ms": ms["total"],
                "share": {k: v / ms["total"] for k, v in parts.items()}}


def child_measure(num_envs: int, device: str) -> None:
    """Measure env-steps/s at `num_envs` on `device`; print one JSON
    line and exit."""
    import torch
    import mj_envs_torch  # noqa: F401  (float32 matmul settings)
    from mj_envs_torch import envs
    from mj_envs_torch.parallel.vector import VectorEnv, random_actions
    from mj_envs_torch.physics import kernels

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    chunk = int(os.environ.get("BENCH_CHUNK",
                               512 if num_envs >= 2048 else 0))
    env = envs.make(TASK, device=dev)
    venv = VectorEnv(env, num_envs, chunk_size=chunk)
    gen = torch.Generator(device=dev).manual_seed(1)

    def actions():
        return random_actions(gen, num_envs, env.nu, dev)

    t0 = time.perf_counter()
    st = venv.reset(seed=0)
    st = venv.step(st, actions())
    sync()
    warmup_s = time.perf_counter() - t0

    kernels.reset_launches()
    rates = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(MEASURE_STEPS):
            st = venv.step(st, actions())
        sync()
        rates.append(num_envs * MEASURE_STEPS / (time.perf_counter() - t0))
    launches = dict(kernels.launches)
    for name, t in (("qpos", st.data.qpos), ("obs", st.obs),
                    ("reward", st.reward)):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"non-finite {name} after the timed steps")

    with _Parts(env, sync) as parts:
        st = venv.step(st, actions())
    sync()

    base, why = baseline_steps_per_s()
    rec = {"num_envs": num_envs, "steps_per_s": statistics.median(rates),
           "repeats": rates, "min": min(rates), "max": max(rates),
           "steps_per_repeat": MEASURE_STEPS, "chunk": chunk,
           "warmup_s": warmup_s, "launches": launches,
           "task_env": parts.result(),
           "nan_resets": int(st.nan_resets.sum()),
           "contact_clips": int(st.contact_clips.sum()),
           "baseline_steps_per_s": base, "baseline_error": why,
           "device": (torch.cuda.get_device_name(dev) if on_card
                      else "cpu")}
    if on_card:
        try:
            rec["gpu"] = gpu_info()
        except Exception as e:
            rec["gpu"] = f"nvidia-smi failed: {type(e).__name__}: {e}"
    print(json.dumps(rec), flush=True)


def probe() -> None:
    """Print DEVICE=<name of CUDA device 0> or DEVICE=none: <why>."""
    try:
        import torch
        if torch.cuda.is_available():
            print("DEVICE=" + torch.cuda.get_device_name(0), flush=True)
        else:
            print("DEVICE=none: torch.cuda.is_available() is false",
                  flush=True)
    except Exception as e:
        print(f"DEVICE=none: {type(e).__name__}: {e}", flush=True)


def failed(error: str) -> None:
    print(json.dumps({
        "metric": f"{TASK} env-steps/s/chip (FAILED to measure)",
        "value": 0.0, "unit": "env-steps/s", "vs_baseline": 0.0,
        "error": error[-1500:]}), flush=True)
    sys.exit(1)


def main():
    me = os.path.abspath(__file__)
    device = "none: probe timed out"
    try:
        out = subprocess.run(
            [sys.executable, me, "--probe"], capture_output=True, text=True,
            cwd=ROOT, timeout=float(os.environ.get("BENCH_PROBE_TIMEOUT",
                                                   300)))
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("DEVICE=")]
        device = lines[-1].split("=", 1)[1] if lines else (
            "none: probe rc=%d %s" % (out.returncode,
                                      (out.stderr or "").strip()[-300:]))
    except subprocess.TimeoutExpired:
        pass
    if device.startswith("none"):
        failed(f"no CUDA device ({device[4:].lstrip(': ')}); the port's "
               "bench runs on the card only")

    sizes = [int(s) for s in os.environ.get(
        "BENCH_SIZES", f"{NORTH_STAR},1024").split(",")]
    results, errors = [], []

    def headline(rec) -> str:
        base = rec.get("baseline_steps_per_s", float("nan"))
        vs = rec["steps_per_s"] / base if base == base and base > 0 \
            else -1.0
        return json.dumps({
            "metric": f"{TASK} env-steps/s/chip @ {rec['num_envs']} envs "
                      f"({rec['device']})",
            "value": round(rec["steps_per_s"], 1),
            "unit": "env-steps/s",
            "vs_baseline": round(vs, 2)})

    def try_size(n):
        remaining = DEADLINE_S - (time.time() - _T0) - 30.0
        if results and remaining < 120.0:
            return "deadline"
        try:
            out = subprocess.run(
                [sys.executable, me, "--child", str(n)], capture_output=True,
                text=True, cwd=ROOT, timeout=max(60.0, remaining))
        except subprocess.TimeoutExpired:
            errors.append(f"{n}: timeout")
            return "timeout"
        for line in out.stdout.splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "steps_per_s" in rec:
                results.append(rec)
                print(json.dumps(rec), flush=True)
                print(headline(rec), flush=True)
                return "ok"
        tail = (out.stderr or "").strip().splitlines()[-6:]
        errors.append(f"{n}: rc={out.returncode} " + " | ".join(tail))
        return "crash"

    for n in sizes:
        status = try_size(n)
        if status in ("deadline", "timeout"):
            break
        if status == "crash" and not results:
            # Smaller sizes, on the card only: each line names its size.
            for fb in (1024, 256, 128):
                if fb < n and try_size(fb) == "ok":
                    break
            break

    if not results:
        failed("; ".join(errors) or "no child completed")
    ns = [r for r in results if r["num_envs"] == NORTH_STAR]
    final = ns[0] if ns else max(results, key=lambda r: r["steps_per_s"])
    if results[-1] is not final:
        print(headline(final), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    args = sys.argv[1:]
    if len(args) >= 2 and args[0] == "--child":
        dev = args[args.index("--device") + 1] if "--device" in args \
            else "cuda"
        child_measure(int(args[1]), dev)
    elif args[:1] == ["--probe"]:
        probe()
    else:
        main()
