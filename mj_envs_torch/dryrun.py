"""The dry run of the PyTorch port: entry points in the style of the JAX
package's `__graft_entry__.py`.

`entry()` -- one batched hammer-v0 step of 8 envs, as a function and its
arguments.

`dryrun_multichip(n)` -- an (env, model) mesh over the n ranks of the
process group (the model axis 2 when n is even and above 1), then on
hammer-v0: a reset and one auto-reset step through
`VectorEnv(mesh=...)`, and one PPO iteration over the mesh at hidden
(256, 256).  With a model axis of 2 each `nn.Linear` whose output width
divides by 2 is column-sharded over "model" (tensor parallelism, as
`__graft_entry__.py` shards each such weight); the env state is sharded
over "env".  After the iteration it checks that the layout held.

`vector_check(num_envs)` -- hammer-v0 through `VectorEnv(mesh=...)` over
every rank of the group (model axis 1) against a plain `VectorEnv` of
the whole batch on each rank: this rank's rows bit for bit, and both
rates.

    torchrun --nproc_per_node=N -m mj_envs_torch.dryrun           # N cards
    python -m mj_envs_torch.dryrun                    # one card, one rank
    torchrun --nproc_per_node=2 -m mj_envs_torch.dryrun --device cpu
    torchrun --nproc_per_node=N -m mj_envs_torch.dryrun --vector 4096
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import torch
import torch.distributed as dist

HIDDEN = 256


def entry(device="cuda"):
    """(fn, (state, actions)): fn is the batched auto-reset step of 8
    hammer-v0 envs after a reset, the actions zeros."""
    from . import envs
    from .parallel.vector import VectorEnv

    env = envs.make("hammer-v0", device=device)
    venv = VectorEnv(env, 8)
    state = venv.reset(seed=0)
    actions = torch.zeros((8, env.nu), dtype=torch.float32,
                          device=env.device)
    return venv.step, (state, actions)


def _check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def dryrun_multichip(n_devices: int, device="cuda") -> Dict[str, float]:
    """One sharded PPO iteration over the n ranks of the process group
    (module docstring); returns its metrics."""
    from torch import nn
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   parallelize_module)

    from . import envs
    from .algos import ppo as PPO
    from .parallel import distributed as D
    from .parallel.vector import VectorEnv

    _check(dist.is_initialized() and dist.get_world_size() == n_devices,
           f"dryrun_multichip({n_devices}) needs a process group of "
           f"{n_devices} ranks (parallel/distributed.initialize)")
    model_dim = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = D.make_mesh(model_axis=model_dim, device=device)

    env = envs.make("hammer-v0", device=device)
    num_envs = 2 * (n_devices // model_dim)
    # Hidden width 256: each model shard owns a 128-wide block of every
    # hidden layer, so the tensor-parallel axis carries real work.
    cfg = PPO.PPOConfig(n_steps=2, n_minibatches=2, n_epochs=1,
                        hidden=(HIDDEN, HIDDEN))
    init_fn, train_iter_fn, _ = PPO.make_ppo(env, num_envs, cfg,
                                             device=device, mesh=mesh)
    ts = init_fn(0)

    venv = VectorEnv(env, num_envs, mesh=mesh)
    env_state = venv.reset(seed=0)
    env_state = venv.step(env_state, torch.zeros(
        (venv.local, env.nu), dtype=env.dtype, device=env.device))

    if model_dim > 1:
        plan = {name: ColwiseParallel(output_layouts=Replicate())
                for name, m in ts.module.named_modules()
                if isinstance(m, nn.Linear) and m.out_features % model_dim
                == 0}
        parallelize_module(ts.module, mesh["model"], plan)
        ts.optimizer = PPO.make_optimizer(ts.module, cfg)

    ts, env_state, metrics = train_iter_fn(ts, env_state)

    # The step must keep the layout: the env state this rank's rows, the
    # tensor-parallel weights sharded over "model" (a gather to one rank
    # would pass a check of the values alone).
    _check(env_state.data.qpos.shape[0] == venv.local,
           f"env state lost its env-axis rows: {env_state.data.qpos.shape}")
    if model_dim > 1:
        wide = [(n, p) for n, p in ts.module.named_parameters()
                if p.dim() == 2 and p.shape[0] == HIDDEN]
        bad = [n for n, p in wide if not (
            isinstance(p, DTensor) and p.placements == (Shard(0),)
            and p.device_mesh.mesh_dim_names == ("model",))]
        _check(wide and not bad, f"tensor-parallel weights lost their "
               f"model-axis sharding: {bad}")
    out = {k: float(v) for k, v in metrics.items()}
    print("dryrun_multichip ok:", out, flush=True)
    return out


def _fields(st):
    out = [(f"data.{f}", getattr(st.data, f))
           for f in type(st.data).field_names()]
    out += [(f"var.{f}", t) for f, t in st.var.items()]
    return out + [(f, getattr(st, f)) for f in st.LEAVES]


def _timed_steps(venv, actions, device):
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    st = venv.reset(seed=0)
    sync()
    t0 = time.perf_counter()
    for a in actions:
        st = venv.step(st, a[venv.offset:venv.offset + venv.local])
    sync()
    return st, time.perf_counter() - t0


def vector_check(num_envs: int, steps: int = 2, chunk_size: int = 512,
                 device="cuda"):
    """hammer-v0, `num_envs` envs in chunks of `chunk_size`, a reset and
    `steps` random auto-reset steps, through `VectorEnv(mesh=...)` on
    this rank's rows and through a plain VectorEnv of all of them.
    -> (fields that differ between this rank's rows and the plain run's,
    as (name, max |diff|); this rank's env-steps/s; the plain run's; the
    group's, num_envs x steps over the slowest rank's time)."""
    from . import envs
    from .parallel import distributed as D
    from .parallel.vector import VectorEnv, random_actions

    mesh = D.make_mesh(model_axis=1, device=device)
    env = envs.make("hammer-v0", device=device)
    gen = torch.Generator(device=env.device).manual_seed(9)
    actions = [random_actions(gen, num_envs, env.nu, env.device)
               for _ in range(steps)]
    sharded = VectorEnv(env, num_envs, mesh=mesh, chunk_size=chunk_size)
    mine, secs = _timed_steps(sharded, actions, device)
    plain, plain_secs = _timed_steps(
        VectorEnv(env, num_envs, chunk_size=chunk_size), actions, device)
    lo, hi = sharded.offset, sharded.offset + sharded.local
    bad = [(f, (a.double() - b[lo:hi].double()).abs().max().item())
           for (f, a), (_, b) in zip(_fields(mine), _fields(plain))
           if not torch.equal(a, b[lo:hi])]
    slowest = torch.tensor(secs, dtype=torch.float64, device=env.device)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    return (bad, steps * sharded.local / secs, steps * num_envs / plain_secs,
            steps * num_envs / float(slowest))


def main(argv=None):
    from .parallel import distributed as D

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, the default) or cpu (gloo)")
    ap.add_argument("--vector", type=int, default=0, metavar="NUM_ENVS",
                    help="also run vector_check at this many envs")
    args = ap.parse_args(argv)
    D.initialize(device=args.device)        # torchrun's group, if any
    if not dist.is_initialized():           # one rank of its own
        D.initialize(f"tcp://127.0.0.1:{D.free_port()}", 1, 0,
                     device=args.device)
    try:
        fn, fargs = entry(args.device)
        out = fn(*fargs)
        _check(bool(torch.isfinite(out.obs).all()), "entry: non-finite obs")
        print("entry ok", flush=True)
        dryrun_multichip(dist.get_world_size(), args.device)
        if args.vector:
            bad, rate, plain, group = vector_check(args.vector,
                                                   device=args.device)
            print(f"vector_check rank {dist.get_rank()}: {args.vector} envs "
                  f"over {dist.get_world_size()} ranks, 2 steps: this rank "
                  f"{rate:.1f} env-steps/s, the group {group:.1f}, one "
                  f"rank stepping all of them {plain:.1f}; rows bit for "
                  f"bit: {not bad} {bad}", flush=True)
            _check(not bad, f"sharded rows differ: {bad}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
