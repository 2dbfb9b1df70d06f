"""The port's distributed runtime (`mj_envs_torch/parallel/distributed.py`,
`VectorEnv(mesh=...)`, `make_ppo(mesh=...)`, `mj_envs_torch/dryrun.py`)
on the CPU, in gloo process groups spawned here.

The ranks are this file run as a script (`--worker pair|single|four`),
each given torchrun's variables (MASTER_ADDR, MASTER_PORT on a free
localhost port, WORLD_SIZE, RANK, LOCAL_RANK) and joining through
`initialize(device="cpu")`; every process has a timeout and is killed
when it runs out, so a hung rendezvous fails its test.  Each writes what
it computed with `torch.save`; the tests compare the files:

* two ranks on hammer-v0, 8 envs: `process_local_batch` gives (4, 0) and
  (4, 4); each rank's `VectorEnv(mesh)` reset, 2 steps and a step in
  which every env truncates and resets equal rows [offset, offset + 4)
  of a single-process `VectorEnv(chunk_size=4)` bit for bit, and the
  gathered state the whole of it; the all-reduced mean reward is the
  same on both ranks; one PPO iteration over the mesh (2, 1) gives the
  same params bit for bit on both ranks and in the single process on the
  8 envs with step_chunk 4;
* two ranks on door-v0 in float64, one env each: one PPO iteration over
  the mesh from the JAX package's env state, weights, noise and
  permutations (`tests/test_torch_ppo.py`'s iteration pair) against the
  package's own jitted iteration on both envs, at that file's bounds;
* `dryrun_multichip(2)` (env 1 x model 2, the 256-wide layers column-
  sharded): its layout checks hold, its metrics are finite, the same on
  both ranks and within 1e-5 relative of `dryrun_multichip(1)` (one rank
  of its own) on the same global batch of 2 envs;
* `dryrun_multichip(4)` on four ranks (env 2 x model 2), marked slow as
  `tests/test_multiprocess.py` is: four processes at once.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

_THIS = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(_THIS))
TIMEOUT = 240            # s per group of processes
N_ENVS, CHUNK = 8, 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(mode, world, out):
    """Start `world` ranks of `mode` on a free port: the Popen list."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                   CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
        procs.append(subprocess.Popen(
            [sys.executable, _THIS, "--worker", mode, str(out)], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def _wait(procs):
    """Wait for every process within TIMEOUT; kill them all on a timeout
    or a failure.  -> the outputs."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
            assert p.returncode == 0, f"a rank failed:\n{out[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _jax_iteration(out):
    """The JAX package's side of the mesh PPO iteration: door-v0 in
    float64, `tests/test_torch_ppo.py`'s iteration pair (2 envs, its
    config, weights and draws).  Writes the inputs for the "jaxpair"
    ranks, starts them, then runs the package's jitted iteration.
    -> (the ranks' Popen list, the JAX results)."""
    import jax
    import test_torch_ppo as TPP
    from mj_envs_tpu import envs as jenvs
    from mj_envs_tpu.algos import ppo as JP

    n = TPP.N_ENVS
    jenv = jenvs.make("door-v0", dtype=np.float64)
    cfg = JP.PPOConfig(**TPP.ITER_CFG)
    es = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(1), n))
    p = TPP.jax_params(0, torch.float64, jenv.OBS_DIM, jenv.nu, cfg.hidden)
    key = jax.random.PRNGKey(2)
    noise, ukey = TPP.jax_rollout_draws(key, cfg.n_steps, n, jenv.nu,
                                        np.float64)
    torch.save(dict(
        n_envs=n, cfg=TPP.ITER_CFG, noise=noise,
        perms=TPP.jax_perms(ukey, cfg.n_epochs, cfg.n_steps * n),
        params=jax.tree_util.tree_map(np.asarray, p),
        state=TPP.to_port(es, torch.float64)), out / "jax_inputs.pt")
    procs = _spawn("jaxpair", 2, out)
    tx = TPP.jax_tx(cfg)
    _, train_iter, _ = JP.make_ppo(jenv, n, cfg)
    js, es2, jm = jax.jit(train_iter)(JP.TrainState(p, tx.init(p), key), es)
    return procs, dict(params=js.params, p0=p, metrics=jm,
                       qpos=es2.data.qpos, qvel=es2.data.qvel)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-rank groups and the single process, run side by side
    with the JAX package's iteration."""
    out = tmp_path_factory.mktemp("dist")
    procs = _spawn("pair", 2, out) + _spawn("single", 1, out)
    try:
        more, jax_side = _jax_iteration(out)
        procs += more
    finally:
        _wait(procs)
    load = lambda name: torch.load(out / name, weights_only=False)
    return dict(ranks=[load("pair0.pt"), load("pair1.pt")],
                single=load("single0.pt"),
                jaxpair=[load("jaxpair0.pt"), load("jaxpair1.pt")],
                jax=jax_side)


def test_initialize_is_a_no_op_without_torchrun(monkeypatch):
    from torch import distributed as dist
    from mj_envs_torch.parallel import distributed as D
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    D.initialize(device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        D.make_mesh(device="cpu")


def test_process_local_batch(runs):
    ranks = runs["ranks"]
    assert [r["local_batch"] for r in ranks] == [(4, 0), (4, 4)]


def _equal(a, b):
    return {k: (a[k].double() - b[k].double()).abs().max().item()
            for k in b if not torch.equal(a[k], b[k])}


@pytest.mark.parametrize("stage", ["reset", "step1", "step2", "truncate"])
def test_vector_env_rows_match_single_process(runs, stage):
    """Each rank's rows of the global batch, bit for bit; at "truncate"
    every env reset, drawing from the generator in chunk order."""
    ranks, single = runs["ranks"], runs["single"]
    for r in ranks:
        lo = r["local_batch"][1]
        want = {k: v[lo:lo + 4] for k, v in single[stage].items()}
        assert not _equal(r[stage], want), (lo, _equal(r[stage], want))
        assert not _equal(r[stage + "_global"], single[stage])
    if stage == "truncate":
        assert bool(single[stage]["done"].all())


def test_mean_reward_all_reduced_identical(runs):
    ranks, single = runs["ranks"], runs["single"]
    a, b = (r["mean_reward"] for r in ranks)
    assert a == b and np.isfinite(a)
    assert a == pytest.approx(float(single["step2"]["reward"].mean()),
                              rel=1e-6)


def test_ppo_iteration_params_match_single_process(runs):
    ranks, single = runs["ranks"], runs["single"]
    for r in ranks:
        assert len(r["ppo_params"]) == len(single["ppo_params"])
        for a, b in zip(r["ppo_params"], single["ppo_params"]):
            assert torch.equal(a, b)
        assert r["ppo_metrics"] == single["ppo_metrics"]


def test_dryrun_tensor_parallel_matches_one_rank(runs):
    ranks, single = runs["ranks"], runs["single"]
    a, b = (r["dryrun"] for r in ranks)
    assert a == b
    one = single["dryrun"]
    assert set(a) == set(one)
    for k, v in a.items():
        assert np.isfinite(v), k
        assert abs(v - one[k]) <= 1e-5 * max(abs(v), abs(one[k])), (
            k, v, one[k])


def test_mesh_ppo_iteration_matches_jax(runs):
    """One PPO iteration over the mesh (2, 1), a door-v0 env on each rank
    in float64, against the JAX package's jitted iteration on both envs
    from the same env state, weights and draws: the params, metrics and
    gathered env state of each rank at `tests/test_torch_ppo.py`'s
    float64 iteration bounds (`ITER_F64`)."""
    import test_torch_ppo as TPP
    j = runs["jax"]
    for r in runs["jaxpair"]:
        e = dict(params=TPP.params_error(r["module"], j["params"]),
                 metrics=max(TPP.max_err(r["metrics"][k], j["metrics"][k])
                             for k in j["metrics"]),
                 qpos=TPP.max_err(r["qpos"], j["qpos"]),
                 qvel=TPP.max_err(r["qvel"], j["qvel"]))
        assert TPP.params_error(r["module"], j["p0"]) > 1e-4, e  # it moved
        over = {k: (v, TPP.ITER_F64[k]) for k, v in e.items()
                if not v <= TPP.ITER_F64[k]}
        assert not over, e


@pytest.mark.slow
def test_dryrun_four_ranks(tmp_path):
    _wait(_spawn("four", 4, tmp_path))
    got = [torch.load(tmp_path / f"four{r}.pt", weights_only=False)
           for r in range(4)]
    assert all(g["dryrun"] == got[0]["dryrun"] for g in got)
    assert all(np.isfinite(v) for v in got[0]["dryrun"].values())


# -- the ranks -----------------------------------------------------------------

def _fields(st):
    d = {f: getattr(st.data, f) for f in type(st.data).field_names()}
    d.update({f"var.{f}": t for f, t in st.var.items()})
    d.update({f: getattr(st, f) for f in st.LEAVES})
    return {k: v.detach().clone() for k, v in d.items()}


def _vector_run(env, venv, record, gather=None):
    """reset, 2 random steps and a step in which every env truncates;
    the actions are the global ones, each rank taking its rows."""
    gen = torch.Generator().manual_seed(5)
    rows = slice(venv.offset, venv.offset + venv.local)

    def put(name, st):
        record[name] = _fields(st)
        if gather is not None:
            record[name + "_global"] = _fields(gather(st))

    st = venv.reset(seed=0)
    put("reset", st)
    for name in ("step1", "step2", "truncate"):
        if name == "truncate":
            st = st.replace(step_count=torch.full_like(
                st.step_count, env.MAX_EPISODE_STEPS - 1))
        a = 2.0 * torch.rand(N_ENVS, env.nu, generator=gen) - 1.0
        st = venv.step(st, a[rows])
        put(name, st)
    return st


def _ppo(env, mesh=None):
    from mj_envs_torch.algos import ppo as PPO
    from mj_envs_torch.parallel.vector import VectorEnv
    cfg = PPO.PPOConfig(n_steps=2, n_minibatches=2, n_epochs=2,
                        step_chunk=CHUNK)
    init_fn, it, _ = PPO.make_ppo(env, N_ENVS, cfg, device="cpu", mesh=mesh)
    ts = init_fn(0)
    es = VectorEnv(env, N_ENVS, mesh=mesh, chunk_size=CHUNK).reset(seed=1)
    ts, _, m = it(ts, es)
    return ([p.detach().clone() for p in ts.module.parameters()],
            {k: float(v) for k, v in m.items()})


def _jax_pair(env, out):
    """The mesh PPO iteration on the JAX package's inputs
    (`_jax_iteration`): this rank's rows of the env state, the global
    noise and permutations."""
    from mj_envs_torch.algos import networks as TN
    from mj_envs_torch.algos import ppo as PPO
    from mj_envs_torch.parallel import distributed as D
    inp = torch.load(os.path.join(out, "jax_inputs.pt"), weights_only=False)
    mesh = D.make_mesh(model_axis=1, device="cpu")
    cfg = PPO.PPOConfig(**inp["cfg"])
    _, it, _ = PPO.make_ppo(env, inp["n_envs"], cfg, device="cpu", mesh=mesh)
    mod = TN.actor_critic_from_numpy(inp["params"], device="cpu",
                                     dtype=torch.float64)
    ts = PPO.TrainState(mod, PPO.make_optimizer(mod, cfg),
                        torch.Generator().manual_seed(0), env.generator(0))
    ts, es, m = it(ts, D.shard_env_state(mesh, inp["state"]),
                   noise=torch.as_tensor(inp["noise"]),
                   perms=torch.as_tensor(inp["perms"]))
    es = D.global_env_state(mesh, es)
    return dict(module=mod, metrics={k: float(v) for k, v in m.items()},
                qpos=es.data.qpos, qvel=es.data.qvel)


def _worker(mode, out):
    import torch.distributed as dist
    from mj_envs_torch import envs
    from mj_envs_torch.dryrun import dryrun_multichip
    from mj_envs_torch.parallel import distributed as D
    from mj_envs_torch.parallel.vector import VectorEnv

    torch.set_num_threads(1)
    D.initialize(device="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    rec = {}
    try:
        if mode == "jaxpair":
            rec = _jax_pair(envs.make("door-v0", device="cpu",
                                      dtype=torch.float64), out)
        else:
            env = envs.make("hammer-v0", device="cpu")
        if mode == "pair":
            mesh = D.make_mesh(model_axis=1, device="cpu")
            venv = VectorEnv(env, N_ENVS, mesh=mesh, chunk_size=CHUNK)
            rec["local_batch"] = (venv.local, venv.offset)
            st = _vector_run(env, venv, rec,
                             lambda s: D.global_env_state(mesh, s))
            back = D.shard_env_state(mesh, D.global_env_state(mesh, st))
            assert all(torch.equal(a, b) for a, b in zip(
                _fields(back).values(), _fields(st).values()))
            rec["mean_reward"] = float(D.all_reduce_env(
                mesh, rec["step2"]["reward"].mean()) / world)
            rec["ppo_params"], rec["ppo_metrics"] = _ppo(env, mesh)
        elif mode == "single":
            _vector_run(env, VectorEnv(env, N_ENVS, chunk_size=CHUNK), rec)
            rec["ppo_params"], rec["ppo_metrics"] = _ppo(env)
        if mode != "jaxpair":
            rec["dryrun"] = dryrun_multichip(world, device="cpu")
    finally:
        dist.destroy_process_group()
    torch.save(rec, os.path.join(out, f"{mode}{rank}.pt"))


if __name__ == "__main__":
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        _worker(sys.argv[i + 1], sys.argv[i + 2])
