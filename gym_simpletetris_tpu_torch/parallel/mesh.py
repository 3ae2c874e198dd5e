"""Data parallelism over ``torch.distributed``: the env batch sharded over a
one-axis device mesh, one process per card (port of
``gym_simpletetris_tpu.parallel.mesh``).

The JAX mesh is single-controller: one program sees the global batch and
XLA places its shards. Here every rank is a process of its own that holds
its block of ``global_batch // world`` envs, born on its card: rank r owns
the envs [r * b, (r + 1) * b) of the global batch. The engine is
elementwise over the batch, so a step needs no communication; what makes a
block equal bit for bit to the same envs of the unsharded batch is the
draws: each per-env spawn draw takes its threefry counter from the env's
global index (``EnvState.env_offset``, ``core/threefry.py``'s blocks), so a
rank draws exactly its envs' share of the global draw.

- ``init_distributed``: the process group (NCCL on the card, gloo on the
  CPU or when named), the rank's card set;
- ``make_data_mesh``: a 1-D ``DeviceMesh`` over the world, axis ``"data"``
  (a 2-D (``data``, ``model``) mesh comes from ``init_device_mesh``, the
  model axis for the trainers' tensor parallelism); ``data_axis`` /
  ``model_axis``: an axis's group, this rank's index on it and its size;
- ``state_sharding``: the batch axis of each ``EnvState`` field, and
  ``shard_state`` / ``gather_state`` between a global state and the blocks;
- ``ShardedTetrisEnv``: reset / step / rollout on the rank's block;
- ``shard_map_step``: JAX's explicit variant, each rank folding its rank
  into the key;
- ``global_metrics``: the episode sums over every rank, one ``all_reduce``.

gloo takes the CUDA tensors of ``all_reduce``, ``all_gather`` and
``broadcast`` as they are (checked on the H100 by ``chip_smoke.py`` phase
9b), so no collective copies its operands to the host.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor.placement_types import Replicate, Shard

from ..api import spaces
from ..api.env import (build_observation, build_rollout, check_device,
                       reset_fn, step_fn)
from ..core import engine as E
from ..core import threefry
from ..core.config import EnvConfig
from ..core.state import FIELDS, EnvState

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join the process group: a no-op at one process without a
    coordinator. ``coordinator_address``: ``host:port`` (a TCP store), or an
    ``init_method`` URL (``tcp://...``, ``file://...``); without one the
    group reads ``torchrun``'s environment (``MASTER_ADDR``, ``WORLD_SIZE``,
    ``RANK``). The backend is NCCL where a card is present, else gloo, or
    the one named. Where a card is present the rank's card is set first
    (``LOCAL_RANK``, else the rank, modulo the cards). A process already in
    a group stays in it."""
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if coordinator_address is None and num_processes == 1:
        return
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group, if any (a leftover default group makes a
    later ``init_process_group`` of the same process fail)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_data_mesh(device="cuda") -> DeviceMesh:
    """A 1-D mesh over every rank of the world, its axis ``DATA_AXIS``, on
    ``device``'s type. At one process with no process group, it makes a
    group of one first (an in-process store), as a single card needs no
    coordinator."""
    device = check_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1, rank=0)
    return init_device_mesh(device.type, (dist.get_world_size(),),
                            mesh_dim_names=(DATA_AXIS,))


def data_axis(mesh: DeviceMesh):
    """(process group, this rank's index, size) of the mesh's data axis."""
    names = mesh.mesh_dim_names or (DATA_AXIS,)
    dim = names.index(DATA_AXIS)
    return (mesh.get_group(dim), mesh.get_local_rank(dim), mesh.size(dim))


def model_axis(mesh: DeviceMesh, name: str = MODEL_AXIS):
    """(process group, this rank's index, size) of the mesh's model axis
    ``name``; (None, 0, 1) where the mesh has none."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        return None, 0, 1
    dim = names.index(name)
    return (mesh.get_group(dim), mesh.get_local_rank(dim), mesh.size(dim))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on the mesh: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated along ``dim`` in rank
    order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def block(x: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    """Block ``index`` of ``n`` equal blocks of ``x`` along ``dim``, as a
    tensor of its own."""
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size).clone()


# ------------------------------------------------------------------ placement

def state_sharding(cfg=None) -> dict:
    """The placement of each ``EnvState`` field on the data axis (JAX's
    ``state_sharding`` PartitionSpecs): rows ``[H, B]`` / ``[H, NW, B]`` on
    their last axis, ``shape_counts`` on its last axis, the per-env scalars
    on their only axis, the key replicated. ``cfg``: an ``EnvConfig``, or
    an ``EnvState`` whose rows layout says whether they are wide."""
    if isinstance(cfg, EnvState):
        wide = cfg.rows.dim() == 3
    else:
        wide = cfg is not None and cfg.num_words > 1
    out = {f: Shard(0) for f in FIELDS}
    out.update(rows=Shard(2 if wide else 1), shape_counts=Shard(1),
               key=Replicate())
    return out


def shard_dims(placements: dict) -> dict:
    """{name: the sharded dim, or None where replicated} of placements."""
    return {k: p.dim if isinstance(p, Shard) else None
            for k, p in placements.items()}


def state_dims(state: EnvState) -> dict:
    """Each field's batch axis (None for the key): ``state_sharding`` of
    the state's own rows layout."""
    return shard_dims(state_sharding(state))


def shard_state(state: EnvState, mesh: DeviceMesh) -> EnvState:
    """This rank's block of a global ``EnvState`` (a checkpoint's, a
    test's), with its ``env_offset``."""
    _, rank, n = data_axis(mesh)
    dims = state_dims(state)
    b = state.batch_size // n
    return state.replace(env_offset=state.env_offset + rank * b, **{
        f: block(getattr(state, f), d, rank, n)
        for f, d in dims.items() if d is not None})


def gather_state(state: EnvState, mesh: DeviceMesh) -> EnvState:
    """The global ``EnvState`` from every rank's block (on every rank):
    one ``all_gather`` per field."""
    group, _, _ = data_axis(mesh)
    dims = state_dims(state)
    return state.replace(env_offset=0, **{
        f: all_gather_cat(getattr(state, f), group, d)
        for f, d in dims.items() if d is not None})


# ------------------------------------------------------------------ the env

class ShardedTetrisEnv:
    """``TetrisVectorEnv`` with the batch sharded over the mesh's data axis.

    Each rank holds envs [r * b, (r + 1) * b) of ``global_batch``, b =
    global_batch // world, born on its device; observations, rewards,
    dones and states are the rank's block, bitwise the same rows of the
    unsharded env at ``global_batch``. ``step`` / ``rollout`` take the
    block's actions ([b] / [T, b]) or the global ones ([B] / [T, B]), of
    which the block is taken. Nothing communicates.

    >>> init_distributed()                 # under torchrun
    >>> mesh = make_data_mesh()
    >>> env = ShardedTetrisEnv(EnvConfig(auto_reset=True), 4096 * world, mesh)
    >>> obs, state = env.reset(0)          # the same key on every rank
    >>> obs, state, rew, done, info = env.step(state, actions)
    """

    def __init__(self, config: EnvConfig, global_batch: int,
                 mesh: Optional[DeviceMesh] = None):
        self.config = config
        self.mesh = mesh if mesh is not None else make_data_mesh()
        _, rank, n = data_axis(self.mesh)
        if global_batch % n:
            raise ValueError(f"global_batch {global_batch} % mesh size {n} "
                             "!= 0")
        self.global_batch = global_batch
        self.batch_size = global_batch // n
        self.env_offset = rank * self.batch_size
        self.device = mesh_device(self.mesh)
        self._rollout = build_rollout(config, self.batch_size, self.obs_shape)

    @property
    def obs_shape(self):
        return spaces.observation_space(self.config).shape

    def _block(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device).to(torch.int32)
        if x.shape[-1] == self.batch_size:
            return x
        if x.shape[-1] != self.global_batch:
            raise ValueError(f"actions of batch {x.shape[-1]}: want the "
                             f"block's {self.batch_size} or the global "
                             f"{self.global_batch}")
        return x[..., self.env_offset:self.env_offset + self.batch_size]

    def reset(self, key):
        """(obs, state) of the block from a seed or key data, the same on
        every rank."""
        return reset_fn(self.config, self.batch_size, key, device=self.device,
                        env_offset=self.env_offset)

    def step(self, state: EnvState, action):
        return step_fn(self.config, state, self._block(action))

    def rollout(self, state: EnvState, actions):
        """(final state, obs accumulator, reward [T, b], done [T, b]) of the
        block; see ``api.env.build_rollout``."""
        return self._rollout(state, self._block(actions))


def shard_map_step(cfg: EnvConfig, mesh: DeviceMesh):
    """JAX's explicit per-shard step: (state, action) of the block ->
    (obs, state, reward, done, finished). Each rank folds its data-axis
    index into the replicated key and draws for its envs at local offsets
    0..b-1 (decorrelated shards, not the unsharded stream); the carried key
    is re-derived from the pre-fold key, so it stays replicated; ``finished``
    is the global count of episodes ended this step (one ``all_reduce``).
    No auto-reset, as in JAX."""
    group, rank, _ = data_axis(mesh)

    def local_step(state: EnvState, action):
        action = torch.as_tensor(action, device=state.device)
        local = state.replace(key=threefry.fold_in(state.key, rank),
                              env_offset=0)
        out = E.engine_step(cfg, local, action)
        new_key = threefry.split(state.key)[0]
        st = out.state.replace(key=new_key, env_offset=state.env_offset)
        obs = build_observation(cfg, out.emitted_rows)
        finished = out.done.sum().to(torch.int32)
        dist.all_reduce(finished, group=group)
        return obs, st, out.reward, out.done, finished

    return local_step


_METRIC_SUMS = ("deaths", "lines_cleared", "score", "holes", "time")


def global_metrics(state: EnvState, mesh: Optional[DeviceMesh] = None) -> dict:
    """Aggregate episode metrics over the global batch: the five sums and
    the env count in one ``all_reduce`` over the mesh's data axis (none
    without a mesh); ``mean_score`` and ``mean_holes`` are the global sums
    over the global count, in float32 as ``jnp.mean`` gives them."""
    from ..train.replay import _recip_f32
    sums = torch.stack([getattr(state, f).to(torch.int64).sum()
                        for f in _METRIC_SUMS]
                       + [torch.tensor(state.batch_size, device=state.device)])
    if mesh is not None:
        dist.all_reduce(sums, group=data_axis(mesh)[0])
    deaths, lines, score, holes, time, count = sums.unbind()
    mean = lambda s: s.to(torch.float32) * _recip_f32(int(count))
    return {"total_deaths": deaths.to(torch.int32),
            "total_lines": lines.to(torch.int32),
            "mean_score": mean(score), "mean_holes": mean(holes),
            "env_steps": time.to(torch.int32)}
