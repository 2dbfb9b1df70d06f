"""kind `ppo_mesh`: the port's PPO trainer data-parallel over `ranks`
processes, one a card: an (env `ranks`, model 1) mesh, each rank on its
rows of the global batch of `num_envs` (`make_ppo(mesh=...)`: the
rollout on its rows, GAE, the gather over the env axis, the same update
on the gathered batch on every rank).  One unit is one iteration on
every rank.

Rank 0 runs in the harness's process on the harness's card; ranks 1 to
`ranks` - 1 are this file run as a script (`--worker`), each on the card
of its rank, joined by `distributed.initialize` on a free localhost
port (NCCL between cards, gloo on the CPU; each collective and the
rendezvous bounded by GROUP_TIMEOUT_S).  Each unit starts with rank
0's broadcast of whether another iteration follows and whether it is
timed (the harness's `timings`, which add an all-reduce on every
rank).  A worker that exits before it is told to, or exits non-zero, ends rank
0's process at once with exit code 1, the other workers killed first; a
worker whose parent has gone exits.

The draws are `kinds/ppo.py`'s for the global batch: the same weights,
noise and permutations on every rank, each rank acting on its rows of
the noise; the start is `VectorEnv(mesh=...).reset` from the
benchmark's own seed, whose generator then serves the auto-resets; the
episode phases are a global draw's rows.

The check keeps `kinds/ppo.py`'s numbers and limits, applied to the
global batch: in the warm-up iteration and the window's last, every
rank's physics on its sampled rows (ranks 1.. send theirs to rank 0
after the window, a file each), the policy on every gathered row, GAE,
and the update against the reference's update on the reference's own
GAE.  In the last iteration's whole update, a row whose ratio lies at
a clip tie (within TIE of the bound that decides its gradient, where
float32 and float64 can fall on either side) takes the side that the
program's applied gradient at that step shows (`_ties`): a tie decided
the other way moves the update's end by ~1e-4 of its change, where the
sound readings lie near 1e-6.  Two exact numbers of its own:

* `ranks_params_differ`: parameter leaves of ranks 1.. that differ from
  rank 0's after the last iteration, bit for bit;
* `draws_differ`: sampled start rows and restarted rows whose drawn
  randomization is not what one process over the global batch draws for
  that row: the reference's own `_reset_var` in float32, replayed from
  the reset seed over the global batch's chunks in row order (the
  port's shard plan, `parallel/vector.py`).
"""
from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import traceback
from typing import Dict, List, Optional, Tuple

import torch

from ..lib import check, drive, trace
from ..lib.spec import ROOT
from . import ppo as P

F64 = torch.float64
GROUP_TIMEOUT_S = 300      # each collective and the rendezvous
JOIN_TIMEOUT_S = 120       # the workers' reports and exit after the stop
POLL_S = 0.2               # how often rank 0 looks at its workers
STOP, RUN, TIMED = 0, 1, 2     # rank 0's broadcast before each unit

# The fault planted under this kind (`FAULTS`), which each rank plants
# on its own terms (`_plant_own`).
PLANTED: Optional[str] = None


class Capture(P.Capture):
    """`kinds/ppo.py`'s records of one iteration, and the gathered batch:
    the results of the iteration's `all_gather_rows` calls in order (the
    trajectory's fields, then the advantages and the returns); on rank 0
    also the parameters and the applied (clipped) gradient before each
    Adam step, each flattened in the module's order (`_ties`)."""

    def begin(self) -> None:
        super().begin()
        self.gathered: List[torch.Tensor] = []
        self.updates: List[tuple] = []

    def install(self) -> None:
        super().install()
        cap = self

        def gather(orig):
            def w(mesh, x, dim=0):
                out = orig(mesh, x, dim=dim)
                cap.gathered.append(out)
                return out
            return w
        self.patches.wrap("mj_envs_torch.algos.ppo:all_gather_rows", gather)
        if self.drive.rank:
            return
        params = list(self.drive.ts.module.parameters())
        inner = self._opt.step

        def step(*a, **k):
            cap.updates.append((
                torch.cat([p.detach().reshape(-1) for p in params]),
                torch.cat([p.grad.detach().reshape(-1) for p in params])))
            return inner(*a, **k)
        self._opt.step = step


class Rank(P.Drive):
    """One rank's trainer on its rows of the global batch: the warm-up
    iteration recorded at set-up, then each iteration recorded from
    `mark()` on, the last kept."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 limits: dict, rank: int = 0):
        super().__init__(config, traffic, seed, device, limits)
        self.limits, self.rank = limits, rank
        self.world = int(traffic["ranks"])
        self.units = 0

    def ppo_config(self):
        return super().ppo_config()._replace(
            step_chunk=int(self.traffic["step_chunk"]))

    def setup(self) -> None:
        from mj_envs_torch import envs
        from mj_envs_torch.algos.ppo import make_ppo
        from mj_envs_torch.parallel import distributed as D
        from mj_envs_torch.parallel.vector import VectorEnv
        mesh = D.make_mesh(model_axis=1, device=self.device.type)
        self.env = envs.make(self.config["env_id"], device=self.device)
        self.cfg = self.ppo_config()
        n = self.num_envs
        init_fn, self.train_iter, _ = make_ppo(
            self.env, n, self.cfg, device=self.device, mesh=mesh)
        self.ts = init_fn(drive.sub_seed(self.seed, "init"))
        self.weights = drive.policy_weights(
            self.seed, self.env.OBS_DIM, self.env.nu, self.cfg.hidden,
            self.device)
        with torch.no_grad():
            self.ts.module.load_state_dict(self.weights)
        venv = VectorEnv(self.env, n, mesh=mesh,
                         chunk_size=self.cfg.step_chunk)
        self.local, self.offset = venv.local, venv.offset
        state = venv.reset(drive.sub_seed(self.seed, "resets"))
        self.ts.reset_generator = venv.generator
        if self.traffic.get("staggered_phase"):
            lo, hi = self.traffic.get(
                "phase_range", (0, self.config["max_episode_steps"]))
            sc = torch.randint(
                lo, hi, (n,), generator=drive.generator(
                    self.device, self.seed, "phase"),
                device=self.device, dtype=torch.int32)
            state = state.replace(
                step_count=sc[self.offset:self.offset + self.local])
        self.initial = self.state = state
        self.gen_noise = drive.generator(self.device, self.seed, "noise")
        self.gen_perm = drive.generator(self.device, self.seed, "perms")
        self.warmup = self.recording = Capture(self)
        self.warmup.install()
        try:
            self.unit()
        finally:
            self.warmup.uninstall()
        self.recording = None

    def unit(self) -> int:
        """One iteration after rank 0's broadcast, which says whether it
        is timed; 0 env-steps and no iteration where rank 0 says STOP."""
        code = _flag(RUN if self.timings is None else TIMED, self.device)
        if code == STOP:
            return 0
        if self.rank:
            self.timings = [] if code == TIMED else None
        n = super().unit()
        self.units += 1
        return n

    def mark(self) -> None:
        """The window starts: record each iteration, keeping the last."""
        self.window_start = self.state
        self.last = self.recording = Capture(self)
        self.last.install()

    def report(self) -> dict:
        """What the check reads of this rank: its rows, iterations,
        failures and parameters after the last iteration, its sampled
        start rows, and the pieces of the warm-up and last iterations
        (`_piece`)."""
        lim, seed, r = self.limits, self.seed, self.rank
        rows = check.sample(seed, f"start{r}.", self.initial,
                            lim["sample_envs"], 0)
        return dict(
            offset=self.offset, local=self.local, units=self.units,
            failed=P.Drive.failed(self),
            params={n: p.detach().clone()
                    for n, p in self.ts.module.named_parameters()},
            start=(rows, check.rows_of(self.initial, rows)),
            warm=_piece(self.warmup, lim, seed, f"ppo{r}."),
            last=_piece(self.last, lim, seed, f"last{r}.")
            if self.last.gae is not None else None)


def _piece(cap: Capture, limits: dict, seed: int, tag: str) -> dict:
    """One rank's part of a recorded iteration that the gather does not
    hold: the last values, finishing obs, truncation flags and last obs
    of its rows, and for each step its sampled rows (`kinds/ppo.py`'s
    sample) with their pre-step state, actions and post-step state."""
    steps = cap.steps
    per_step = max(1, limits["sample_envs"] // len(steps))
    phys = []
    for t, (pre, action, post) in enumerate(steps):
        rows = check.sample(seed, f"{tag}{t}", post, per_step,
                            limits["sample_restarts"])
        phys.append((rows, check.rows_of(pre, rows), action[rows],
                     check.rows_of(post, rows)))
    return dict(last_value=cap.gae[1],
                final_obs=torch.stack([m.final_obs for _, _, m in steps]),
                truncated=torch.stack([m.truncated for _, _, m in steps]),
                last_obs=steps[-1][2].obs, phys=phys)


def _cpu(x):
    """`x` with every tensor in it on the CPU (reports, tuples, dicts and
    the reference's EnvStates)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu(v) for v in x)
    if hasattr(x, "map"):
        return x.map(lambda t: t.detach().cpu())
    return x


def _join(init_method: str, rank: int, world: int, device) -> None:
    """Join the group through the port's `initialize`, each collective
    and the rendezvous bounded by GROUP_TIMEOUT_S."""
    from mj_envs_torch.parallel import distributed as D
    D.initialize(init_method, world, rank, device=device.type,
                 timeout=GROUP_TIMEOUT_S)


def _barrier(device) -> None:
    """Every rank here: an all-reduce of one number, waited for."""
    import torch.distributed as dist
    t = torch.zeros(1, device=device)
    dist.all_reduce(t)
    t.item()


def _flag(code: int, device) -> int:
    """Rank 0's broadcast of `code` (STOP, RUN or TIMED); every rank
    gets it back."""
    import torch.distributed as dist
    t = torch.tensor([code], dtype=torch.int64, device=device)
    dist.broadcast(t, src=0)
    return int(t.item())


class Drive(Rank):
    """Rank 0, in the harness's process, and the workers it starts."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 limits: dict):
        super().__init__(config, traffic, seed, device, limits, rank=0)
        self.workers: List[subprocess.Popen] = []
        self.dir: Optional[str] = None
        self.reports: Optional[List[dict]] = None
        self.gather_bytes: List[int] = []
        self.own = trace.Patches()
        self.stopping = self.clean = False
        self.watching = threading.Event()

    def setup(self) -> None:
        from mj_envs_torch import trace as program_trace
        from mj_envs_torch.parallel import distributed as D
        self.dir = tempfile.mkdtemp(prefix="ppo_mesh-")
        init = f"tcp://127.0.0.1:{D.free_port()}"
        args = dict(config=self.config, traffic=self.traffic,
                    seed=self.seed, limits=self.limits,
                    device=self.device.type, init=init, dir=self.dir,
                    fault=PLANTED, traced=program_trace.enabled())
        try:
            for r in range(1, self.world):
                self.workers.append(_spawn(dict(args, rank=r), self.dir))
            threading.Thread(target=self._watch, daemon=True).start()
            _plant_own(self.own, PLANTED, 0, self.world)
            _join(init, 0, self.world, self.device)
            super().setup()
        except BaseException:
            self._end()
            raise

    def unit(self) -> int:
        from mj_envs_torch import trace as program_trace
        self.clean = False
        before = program_trace.counters.get("ppo.gather_bytes", 0)
        n = super().unit()
        if program_trace.enabled():
            self.gather_bytes.append(
                program_trace.counters.get("ppo.gather_bytes", 0) - before)
        self.clean = True
        return n

    def close(self) -> None:
        """Stop the workers after the window's last unit, end the group
        on every rank together once their reports are written (NCCL's
        ending waits for every rank), and read the reports; kill the
        workers where a unit did not finish, and leave the group to the
        process's exit."""
        import torch.distributed as dist
        super().close()
        try:
            if not self.clean:
                return
            self.stopping = True
            _flag(STOP, self.device)
            _barrier(self.device)
            dist.destroy_process_group()
            for p in self.workers:
                p.wait(timeout=JOIN_TIMEOUT_S)
            self.reports = [self.report()] + [
                torch.load(os.path.join(self.dir, f"report{r}.pt"),
                           map_location=self.device, weights_only=False)
                for r in range(1, self.world)]
            if self.gather_bytes:
                print(f"# ppo.gather_bytes per iteration (rank 0): "
                      f"{self.gather_bytes}", file=sys.stderr, flush=True)
        finally:
            self._end()

    def failed(self) -> int:
        return sum(r["failed"] for r in self.reports)

    def _watch(self) -> None:
        """End this process at once where a worker exits before it is
        told to, or exits non-zero."""
        while not self.watching.wait(POLL_S):
            for r, p in enumerate(self.workers, 1):
                code = p.poll()
                if code is not None and (code != 0 or not self.stopping) \
                        and not self.watching.is_set():
                    self._abort(r, code)

    def _abort(self, rank: int, code: int) -> None:
        log = os.path.join(self.dir, f"rank{rank}.log")
        try:
            with open(log) as f:
                tail = f.read()[-4000:]
        except OSError:
            tail = ""
        print(f"ppo_mesh: rank {rank} exited with code {code} "
              f"(log {log}):\n{tail}", file=sys.stderr, flush=True)
        self._kill()
        shutil.rmtree(self.dir, ignore_errors=True)
        os._exit(1)

    def _kill(self) -> None:
        for p in self.workers:
            if p.poll() is None:
                p.kill()
        for p in self.workers:
            p.wait()

    def _end(self) -> None:
        """Workers killed where still running, the watch and this rank's
        own fault ended, the work directory removed."""
        self.watching.set()
        self._kill()
        self.own.undo()
        if self.dir:
            shutil.rmtree(self.dir, ignore_errors=True)


def _spawn(args: dict, out_dir: str) -> subprocess.Popen:
    """Start rank args["rank"]: this file run as a worker, its output in
    `rank<r>.log` in `out_dir`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    with open(os.path.join(out_dir, f"rank{args['rank']}.log"), "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "benchmark.kinds.ppo_mesh", "--worker",
             json.dumps(args)], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL)


def _watch_parent() -> None:
    """Exit this worker once its parent (rank 0's process) has gone."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            threading.Event().wait(1.0)
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def worker(args: dict) -> None:
    """Rank args["rank"]: join, set up, run a unit at each of rank 0's
    broadcasts until it says STOP, write the report for the check, and
    end the group with the other ranks.  On an error it exits at once
    (code 1), leaving the group to the process's exit: NCCL's ending
    would wait for the other ranks."""
    import torch.distributed as dist
    _watch_parent()
    device = torch.device(args["device"])
    if device.type == "cpu":
        torch.set_num_threads(1)
    drive.apply_options(args["config"])
    if args["traced"]:
        from mj_envs_torch import trace as program_trace
        program_trace.enable()
    rank = args["rank"]
    own = trace.Patches()
    _plant_own(own, args["fault"], rank, int(args["traffic"]["ranks"]))
    _join(args["init"], rank, int(args["traffic"]["ranks"]), device)
    try:
        r = Rank(args["config"], args["traffic"], args["seed"], device,
                 args["limits"], rank=rank)
        r.setup()
        r.mark()
        while r.unit():
            pass
        r.close()
        torch.save(_cpu(r.report()),
                   os.path.join(args["dir"], f"report{rank}.pt"))
        _barrier(device)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    own.undo()


# -- faults ------------------------------------------------------------------

def _swapped_gather(p):
    """The gather returns the last two ranks' rows swapped (on every
    rank)."""
    def make(orig):
        def gather(mesh, x, dim=0):
            out = orig(mesh, x, dim=dim)
            k, n = x.shape[dim], out.shape[dim]
            idx = torch.arange(n, device=out.device)
            a, b = n - 2 * k, n - k
            idx[a:b], idx[b:] = idx[b:].clone(), idx[a:b].clone()
            return out.index_select(dim, idx)
        return gather
    p.wrap("mj_envs_torch.algos.ppo:all_gather_rows", make)


def _unskipped_draws(p):
    """The reset generator does not skip the other ranks' draws."""
    p.wrap("mj_envs_torch.envs.base:AdroitEnv.skip_reset_draws",
           lambda orig: lambda self, num_envs, generator: None)


# name: (the ranks that plant it, of `world`; the plant)
_OWN = {
    "swapped_gather": (lambda world: range(world), _swapped_gather),
    "unskipped_draws": (lambda world: [world - 1], _unskipped_draws),
    "skipped_step": (lambda world: [world - 1], P._unchanged),
}


def _plant_own(p: trace.Patches, name: Optional[str], rank: int,
               world: int) -> None:
    """This rank's part of the fault `name` (none where it is not one of
    this kind's or not this rank's)."""
    if name in _OWN and rank in _OWN[name][0](world):
        _OWN[name][1](p)


def _planted(name: str):
    def plant(p):
        p.wrap(f"{__name__}:PLANTED", lambda orig: name)
    return plant


# The last two ranks' rows swapped in the gather; the last rank's reset
# generator not skipping the other ranks' draws; the last rank's
# optimizer step returning its state unchanged.  The env-level faults
# (`altered`, `merge`) are `lib/faults.py`'s, planted on rank 0.
FAULTS = {name: _planted(name) for name in _OWN}


# -- the check -------------------------------------------------------------

class _Global(P._Iteration):
    """`kinds/ppo.py`'s iteration over the global batch: the trajectory,
    advantages and returns that rank 0 gathered, and every rank's last
    values, finishing obs, truncation flags, last obs and sampled
    physics rows joined in row order."""

    def __init__(self, cap: Capture, pieces: List[dict]):
        from mj_envs_torch.algos.ppo import Transition
        n = len(Transition._fields)
        if len(cap.gathered) != n + 2:
            raise RuntimeError(
                f"{len(cap.gathered)} gathers in an iteration, not the "
                f"trajectory's {n} fields, the advantages and the returns")
        self.traj = Transition(*cap.gathered[:n])
        self.advs, self.rets = cap.gathered[n], cap.gathered[n + 1]
        self.last_value = torch.cat([p["last_value"] for p in pieces])
        self.final_obs = torch.cat([p["final_obs"] for p in pieces], dim=1)
        self.truncated = torch.cat([p["truncated"] for p in pieces], dim=1)
        self.last_obs = torch.cat([p["last_obs"] for p in pieces])
        self.noise, self.perms = cap.noise, cap.perms
        self.params0, self.adam0 = cap.params0, cap.adam0
        self.params_end = cap.params_end
        self.phys = [(pre, a, post) for p in pieces
                     for _, pre, a, post in p["phys"]]
        self.updates = cap.updates
        self.nudges: Dict[Tuple[int, int], float] = {}

    def batches(self, traffic, obs, action, logp, advs, rets, dtype,
                count: Optional[int] = None) -> List[tuple]:
        """`kinds/ppo.py`'s minibatches, with the old log-prob of each
        tie row in `nudges` ((step, row) -> value) put in its place."""
        out = super().batches(traffic, obs, action, logp, advs, rets, dtype,
                              count)
        for (i, j), v in self.nudges.items():
            if i < len(out):
                old = out[i][2].clone()
                old[j] = v
                out[i] = out[i][:2] + (old,) + out[i][3:]
        return out


class Check(P.Check):
    """`kinds/ppo.py`'s check on the global batch, with
    `ranks_params_differ` and `draws_differ` (module docstring)."""

    def __init__(self, d: Drive, cell, seed: int):
        self.config, self.traffic = cell.config, cell.traffic
        self.seed = seed
        reports = self.reports = d.reports
        w = d.warmup
        self.warm = _Global(w, [r["warm"] for r in reports])
        # the warm-up starts from the benchmark's own weights
        self.warm.params0 = {k: v.clone() for k, v in d.weights.items()}
        self.losses = torch.stack(w.losses)
        self.first_moment, self.params3 = w.first_moment, w.params3
        self.last = _Global(d.last, [r["last"] for r in reports]) \
            if d.last.gae is not None else None
        self.start = check.cat_states([r["start"][1] for r in reports])
        self.params_differ = sum(
            not torch.equal(p, reports[0]["params"][k])
            for r in reports[1:] for k, p in r["params"].items())

    def numbers(self, device, control: bool = False) -> Dict[str, float]:
        if self.last is not None:
            self.last.nudges = {} if control else _ties(self.last,
                                                        self.traffic)
        out = super().numbers(device, control)
        out["ranks_params_differ"] = float(self.params_differ)
        out["draws_differ"] = float(_draws_differ(
            self.config, self.traffic, self.seed, self.reports, device))
        return out


# A row whose float64 ratio lies this close to the clip bound that
# decides its gradient, relatively, may fall on either side in float32
# (its log-density a sum of 26 rounded terms: ~1e-6 apart); at most
# MAX_TIES such rows a step are resolved.
TIE = 1e-4
MAX_TIES = 6


def _ties(it: _Global, traffic: dict) -> Dict[Tuple[int, int], float]:
    """The clip decisions that the float32 program took on rows at a
    tie, as old log-probs for the reference's minibatches (`_Global.
    batches`): at each Adam step of the update, from the program's own
    parameters before it, the rows of the minibatch whose float64 ratio
    lies within TIE of the bound that decides their gradient (1 + eps
    where the normalized advantage is positive, 1 - eps where it is
    negative); of the ways those rows can fall, the one whose float64
    clipped gradient is nearest the program's applied gradient; each
    such row's old log-prob set so that its ratio lies 2 TIE on that
    side.  A row on the side float64 gives it keeps its value.  Empty
    where the program's steps were not recorded."""
    from ..reference import policy as RP
    if not it.updates:
        return {}
    t, eps = traffic, traffic["clip_eps"]
    tr = it.traj
    g_adv, g_ret = RP.gae(tr.reward.to(F64), tr.value.to(F64), tr.done,
                          tr.trunc_boot.to(F64), it.last_value.to(F64),
                          t["gamma"], t["gae_lambda"])
    batches = P._Iteration.batches(it, t, tr.obs, tr.action, tr.log_prob,
                                   g_adv, g_ret, F64)
    shapes = [(k, v.shape, v.numel()) for k, v in it.params0.items()]

    def leaves(flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, at = {}, 0
        for k, shape, n in shapes:
            out[k] = flat[at:at + n].reshape(shape).to(F64)
            at += n
        return out

    nudges: Dict[Tuple[int, int], float] = {}
    for i, (flat_p, flat_g) in enumerate(it.updates):
        p = leaves(flat_p)
        obs, action, old, adv, ret = batches[i]
        mean, log_std, _ = RP.forward(p, obs)
        logp = RP.log_prob(mean, log_std, action)
        ratio = torch.exp(logp - old)
        adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        bound = torch.where(adv_n > 0, 1 + eps, 1 - eps)
        margin = (ratio / bound - 1).abs()
        near = torch.nonzero((margin < TIE) & (adv_n != 0)).flatten()
        if not len(near):
            continue
        rows = near[torch.argsort(margin[near])][:MAX_TIES].tolist()
        want = leaves(flat_g)
        best = None
        for inside in itertools.product((True, False), repeat=len(rows)):
            lp, cand = old.clone(), {}
            for j, ins in zip(rows, inside):
                # inside the range: below 1 + eps, above 1 - eps
                side = -1.0 if (adv_n[j] > 0) == ins else 1.0
                lp[j] = logp[j] - math.log(float(bound[j])
                                           * (1 + 2 * side * TIE))
                cand[(i, j)] = float(lp[j])
            _, first, _ = RP.update_steps(
                p, [(obs, action, lp, adv, ret)], t["learning_rate"],
                t["grad_clip_norm"], eps, t["vf_coef"], t["ent_coef"])
            gap = sum(float(((first[k] - want[k]) ** 2).sum())
                      for k in want)
            if best is None or gap < best[0]:
                best = (gap, cand)
        nudges.update({ij: v for ij, v in best[1].items()
                       if _flips(v, old[ij[1]], logp[ij[1]], bound[ij[1]])})
    print(f"# ppo_mesh: rows of the last update at a clip tie (within "
          f"{TIE:g} of the bound) set to the program's side against "
          f"float64's: {sorted(nudges)}", file=sys.stderr, flush=True)
    return nudges


def _flips(new_old: float, old, logp, bound) -> bool:
    """Whether the old log-prob `new_old` puts the row's ratio on the
    other side of `bound` than its own old log-prob does."""
    return (float(torch.exp(logp - old)) > float(bound)) != \
        (math.exp(float(logp) - new_old) > float(bound))


def _chunks(local: int, chunk: int):
    """A shard's chunks: one where `local` is not a multiple of (or not
    larger than) `chunk`, as the port's `parallel/vector.py` cuts them."""
    if chunk <= 0 or local <= chunk or local % chunk:
        return [(0, local)]
    return [(i, i + chunk) for i in range(0, local, chunk)]


def _draws_differ(config: dict, traffic: dict, seed: int,
                  reports: List[dict], device) -> int:
    """Sampled start rows, and sampled rows that restarted in a checked
    step, whose drawn randomization differs from the draw that one
    process over the global batch makes for that row: the start one
    draw of every row, then each env step one draw a chunk, the
    global batch's chunks in row order, from the reset seed (the
    reference's `_reset_var` in float32)."""
    ref = check.reference_env(config["env_id"], device, torch.float32)
    n, T = int(traffic["num_envs"]), int(traffic["n_steps"])
    local = reports[0]["local"]
    chunks = [(s + i, s + j) for s in range(0, n, local)
              for i, j in _chunks(local, int(traffic["step_chunk"]))]
    drawn = [(field, ref.spec.name2id("body", body), axis)
             for field, bodies in config["reset_ranges"].items()
             for body, ranges in bodies.items() for axis, _, _ in ranges]

    def values(var) -> torch.Tensor:
        return torch.stack([getattr(var, f)[:, i, a] for f, i, a in drawn],
                           -1)

    # (global step, global rows, the program's drawn values) to check
    want = []
    for r in reports:
        its = [(0, r["warm"])] + ([(r["units"] - 1, r["last"])]
                                  if r["last"] is not None else [])
        for it, piece in its:
            for t, (rows, _, _, post) in enumerate(piece["phys"]):
                done = post.done
                if bool(done.any()):
                    want.append((it * T + t, r["offset"] + rows[done],
                                 values(post.var)[done]))
    gen = ref.generator(drive.sub_seed(seed, "resets"))
    start = values(ref._reset_var(ref.base_var(n), gen))
    bad = sum(int((values(r["start"][1].var) != start[
        r["offset"] + r["start"][0]]).any(-1).sum()) for r in reports)
    last = max((s for s, _, _ in want), default=-1)
    for step in range(last + 1):
        draws = torch.cat([values(ref._reset_var(ref.base_var(j - i), gen))
                           for i, j in chunks])
        for s, rows, got in want:
            if s == step:
                bad += int((got != draws[rows]).any(-1).sum())
    return bad


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(json.loads(sys.argv[2]))
