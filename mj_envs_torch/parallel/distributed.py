"""Multi-process runtime of the PyTorch port
(`mj_envs_tpu/parallel/distributed.py`), on `torch.distributed`.

One process per card (torchrun's layout): `initialize()` joins the
process group, NCCL between cards and gloo for processes on the CPU, and
`make_mesh` lays the ranks out as a 2-D `DeviceMesh` with dims
("env", "model"), rank-major as `jax.devices()` is process-major.  The
env batch is sharded over "env": each rank resets and steps its own rows
(`parallel/vector.VectorEnv(mesh=...)`), and ranks that share an env
coordinate hold the same rows, as the JAX mesh replicates the env state
over "model".  The learner gathers what it needs over "env"
(`algos/ppo.make_ppo(mesh=...)`); the "model" axis carries tensor-
parallel layers (`dryrun.py`).

    torchrun --nproc_per_node=N -m mj_envs_torch.dryrun
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..envs.base import EnvState


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, device="cuda",
               timeout: Optional[float] = None) -> None:
    """Join the process group.

    With no arguments it reads torchrun's MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK and does nothing when they are absent (a plain
    single-process run), so callers call it unconditionally; it also does
    nothing when a group already exists.  NCCL for device "cuda", each
    rank bound to cuda:LOCAL_RANK (the card is required: no fallback to
    the CPU), gloo for device "cpu".  `timeout`, in seconds, bounds
    each collective and the rendezvous (torch's default where None)."""
    if dist.is_initialized():
        return
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and "MASTER_ADDR" in env:
        init_method = (f"tcp://{env['MASTER_ADDR']}:"
                       f"{env.get('MASTER_PORT', '29500')}")
    if init_method is None and world_size is None:
        return                       # single process; nothing to join
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the NCCL group runs on the card; pass "
                "device='cpu' for a gloo group on the CPU")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank or 0)))
    kw = {} if timeout is None else dict(
        timeout=datetime.timedelta(seconds=timeout))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method,
                            world_size=world_size, rank=rank, **kw)


def free_port() -> int:
    """A free TCP port on localhost (for a group's init_method)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


ENV_AXIS = "env"                 # the mesh dim the env batch is sharded over


def make_mesh(model_axis: int = 1, device="cuda"):
    """The (env, model) mesh over every rank of the group: world /
    model_axis env shards of `model_axis` ranks each, rank r at
    (r // model_axis, r % model_axis)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize() first")
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"{n} ranks do not split into model axis "
                         f"{model_axis}")
    return init_device_mesh(torch.device(device).type,
                            (n // model_axis, model_axis),
                            mesh_dim_names=(ENV_AXIS, "model"))


def env_sharding(mesh, dim: int = 0):
    """The DTensor placements of an env-batched tensor whose env rows run
    along `dim`: sharded over the env axis, replicated over every other
    mesh dim (the JAX package's P("env"))."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dim) if name == ENV_AXIS else Replicate()
                 for name in mesh.mesh_dim_names)


def env_shards(mesh, env_axis: str = ENV_AXIS) -> int:
    """The number of env shards: the mesh's size along `env_axis`."""
    return mesh.size(mesh.mesh_dim_names.index(env_axis))


def process_local_batch(mesh, global_num_envs: int,
                        env_axis: str = ENV_AXIS) -> Tuple[int, int]:
    """(local_envs, offset): this rank's rows of the global env batch,
    per_shard = global / env shards at its env coordinate."""
    i = mesh.mesh_dim_names.index(env_axis)
    n_env_shards = env_shards(mesh, env_axis)
    if global_num_envs % n_env_shards:
        raise ValueError(f"{global_num_envs} envs do not split over "
                         f"{n_env_shards} env shards")
    per_shard = global_num_envs // n_env_shards
    return per_shard, per_shard * mesh.get_coordinate()[i]


def shard_env_state(mesh, state: EnvState) -> EnvState:
    """A global EnvState -> this rank's rows of it."""
    local, offset = process_local_batch(mesh, state.batch)
    return state.map(lambda x: x[offset:offset + local])


def all_gather_rows(mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every env shard's `x` joined along `dim` in env-coordinate order
    (each rank's rows at its offset)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, mesh, env_sharding(mesh, dim),
                              run_check=False).full_tensor()


def all_reduce_env(mesh, x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the env shards (a copy; `x` is left as it is)."""
    y = x.clone()
    dist.all_reduce(y, group=mesh.get_group(ENV_AXIS))
    return y


def max_min_env(mesh, value: float, device) -> Tuple[float, float]:
    """(largest, smallest) of a host number over the env shards: one
    all-reduce of two float64s on `device`."""
    t = torch.tensor([value, -value], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(ENV_AXIS))
    hi, neg_lo = t.tolist()
    return hi, -neg_lo


def global_env_state(mesh, local_state: EnvState) -> EnvState:
    """The global EnvState from each rank's rows, gathered over the env
    axis in offset order (every rank gets the whole tree; the JAX
    package's make_array_from_process_local_data)."""
    return local_state.map(lambda x: all_gather_rows(mesh, x))
