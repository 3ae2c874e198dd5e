"""Path-assigned placement of a trainer state on a device mesh (port of
``gym_simpletetris_tpu.train.sharding``).

``train_state_sharding`` gives every tensor of a ``DQNState``, ``PPOState``
or ``ESState``, by its path in the state (never by its shape), one
placement per mesh axis (``torch.distributed.tensor``'s ``Shard(dim)`` /
``Replicate()``), by JAX's rules:

- ``replay``: the ``[S, B, ...]`` ring shards its env axis (dim 1) over
  ``data``, so every rank owns the transitions its envs produced and an
  insert stays rank-local; its scalars (pointer, fill, max priority)
  replicate;
- ``env_state``: ``parallel.mesh.state_sharding`` (rows and shape counts
  on their last axis, the per-env scalars on their only one, the key
  replicated);
- ``obs`` (env-major) on dim 0, the n-step ``window`` ``[n-1, B, ...]`` on
  dim 1;
- ``params`` / ``target_params`` and their Adam mirrors in ``opt_state``:
  tensor parallelism over the ``model`` axis, where the mesh has one. The
  rule is JAX's, on the torch layouts: a flax kernel ``[in, out]`` (HWIO
  for a conv) shards its output axis, its last; the port's ``nn.Linear``
  weight is ``[out, in]`` and a conv weight ``[out, in, kh, kw]``, so the
  same output axis is **dim 0** here. A weight (``weight``, and a
  NoisyDense's ``weight_mu`` / ``weight_sigma``) of 2 or more dims shards
  dim 0 when the model axis divides it; biases and scalars replicate;
- everything else (keys, counters, ES's theta) replicates.

The trainers (``make_train``, ``make_ppo``, ``make_es`` with ``mesh=``)
apply the data axis only: a mesh whose ``model`` axis is larger than 1
raises ``NotImplementedError`` (tensor parallelism is ROADMAP item 15b).
``utils/checkpoint.py`` gathers and shards a state by these placements
(``gather_train_state`` / ``shard_train_state``), and ``DataParallel`` is
the trainers' data-axis plumbing: the rank's env block and learner share,
and their collectives.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor.placement_types import Replicate, Shard

from ..models.actor_critic import cast_points
from ..parallel.mesh import (DATA_AXIS, all_gather_cat, block, data_axis,
                             shard_dims, state_sharding)

MODEL_AXIS = "model"
_KERNEL_LEAVES = ("weight", "weight_mu", "weight_sigma")


def mesh_axes(mesh_shape) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh_shape, Mapping):
        return dict(mesh_shape)
    names = mesh_shape.mesh_dim_names or (DATA_AXIS,)
    return dict(zip(names, mesh_shape.shape))


def check_data_only(mesh) -> None:
    """Raise unless ``mesh`` is data-parallel only (no model axis above 1)."""
    if mesh_axes(mesh).get(MODEL_AXIS, 1) > 1:
        raise NotImplementedError(
            "tensor parallelism over the 'model' mesh axis is not ported "
            "(ROADMAP item 15b); the trainers shard the 'data' axis only")


def leaves(tree, path=()):
    """(path, tensor) of every tensor in a state: dataclass fields and dict
    entries, nested; other values (ints, shapes) are skipped."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name), path + (f.name,))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))


def map_leaves(tree, fn, path=()):
    """The state with every tensor replaced by ``fn(path, tensor)``."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_leaves(getattr(tree, f.name), fn, path + (f.name,))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    return tree


def _param_placement(name: str, leaf: torch.Tensor, axes: dict,
                     model_axis: Optional[str]) -> dict:
    """The model-axis rule: a weight's output axis (dim 0 in torch) over
    the model axis when it divides; else nothing."""
    if (model_axis and model_axis in axes
            and name.split(".")[-1] in _KERNEL_LEAVES and leaf.dim() >= 2
            and leaf.shape[0] % axes[model_axis] == 0):
        return {model_axis: Shard(0)}
    return {}


def _data_placements(state, env_sh: dict) -> dict:
    """{path: the data axis's placement} of every tensor of a trainer
    state, by the rules of the module docstring; ``env_sh``: the env
    state's (``parallel.mesh.state_sharding``)."""
    out = {}
    for path, leaf in leaves(state):
        head = path[0]
        if head == "replay":
            out[path] = Shard(1) if leaf.dim() >= 2 else Replicate()
        elif head == "env_state":
            out[path] = env_sh[path[1]]
        elif head in ("obs", "window"):
            out[path] = Shard(0 if head == "obs" else 1)
        else:
            out[path] = Replicate()
    return out


def train_state_sharding(cfg, mesh_shape, state,
                         model_axis: Optional[str] = MODEL_AXIS) -> dict:
    """{path: (placement per mesh axis, in the mesh's axis order)} for every
    tensor of ``state`` (a DQNState, PPOState or ESState of ``cfg``), by the
    rules of the module docstring. ``mesh_shape``: a ``DeviceMesh`` or
    {axis name: size}; ``model_axis=None`` for data parallelism alone."""
    axes = mesh_axes(mesh_shape)
    data = _data_placements(state, state_sharding(cfg.env))
    out = {}
    for path, leaf in leaves(state):
        spec = {DATA_AXIS: data[path]}
        if path[0] in ("params", "target_params", "opt_state"):
            spec.update(_param_placement(str(path[-1]), leaf, axes,
                                         model_axis))
        out[path] = tuple(spec.get(a, Replicate()) for a in axes)
    return out


def data_dims(state) -> dict:
    """{path: the dim sharded over the data axis, or None} of every tensor
    of a trainer state: the data axis of ``train_state_sharding``, the env
    rows' layout read from the state itself."""
    env = (state_sharding(state.env_state) if hasattr(state, "env_state")
           else {})
    return shard_dims(_data_placements(state, env))


def gather_train_state(state, mesh):
    """The global trainer state from every rank's block, on every rank: each
    data-sharded tensor all-gathered along its axis, the replicated ones
    kept as they are (the same objects)."""
    group, _, _ = data_axis(mesh)
    dims = data_dims(state)
    out = map_leaves(state, lambda p, x: x if dims[p] is None
                     else all_gather_cat(x, group, dims[p]))
    if hasattr(out, "env_state"):
        out = out.replace(env_state=out.env_state.replace(env_offset=0))
    return out


def shard_train_state(state, mesh):
    """This rank's block of a global trainer state (a checkpoint's)."""
    _, rank, n = data_axis(mesh)
    dims = data_dims(state)
    out = map_leaves(state, lambda p, x: x if dims[p] is None
                     else block(x, dims[p], rank, n))
    if hasattr(out, "env_state"):
        es = out.env_state
        out = out.replace(env_state=es.replace(
            env_offset=rank * es.batch_size))
    return out


class DataParallel:
    """The data-parallel plumbing of a trainer over the mesh's data axis:
    the rank's block of ``num_envs`` and share of a ``learn_batch``, and the
    collectives. Without a mesh every method is the unsharded trainer's
    identity."""

    def __init__(self, mesh, device, num_envs: int, learn_batch: int = 0):
        self.mesh = mesh
        self.group, self.rank, self.n = None, 0, 1
        if mesh is not None:
            check_data_only(mesh)
            if torch.device(device).type != mesh.device_type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device_type}")
            self.group, self.rank, self.n = data_axis(mesh)
        for what, v in (("num_envs", num_envs), ("learn_batch", learn_batch)):
            if v % self.n:
                raise ValueError(f"{what} {v} must divide by the mesh's data "
                                 f"axis ({self.n})")
        self.B, self.L = num_envs, learn_batch
        self.b, self.ls = num_envs // self.n, learn_batch // self.n
        self.offset = self.rank * self.b
        # the rank's block of a per-env draw
        self.block = (0, self.offset, self.offset + self.b) if mesh else None

    def broadcast(self, tensors: dict) -> dict:
        """Rank 0's tensors on every rank (one flat broadcast)."""
        if self.mesh is None:
            return tensors
        flat = torch.cat([v.reshape(-1) for v in tensors.values()])
        dist.broadcast(flat, dist.get_global_rank(self.group, 0),
                       group=self.group)
        return dict(zip(tensors, (p.view_as(v).clone() for p, v in zip(
            flat.split([v.numel() for v in tensors.values()]),
            tensors.values()))))

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's block of ``x``, concatenated along ``dim``."""
        if self.mesh is None:
            return x
        return all_gather_cat(x, self.group, dim)

    def share_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's part of a mean over the global env batch (summed over
        the ranks by ``reduce_actor``)."""
        return x.mean() if self.mesh is None else x.mean() * (self.b / self.B)

    def share(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows of a learner batch."""
        return x[self.rank * self.ls:(self.rank + 1) * self.ls]

    def assemble(self, rows: dict, own: torch.Tensor) -> dict:
        """The whole batch on every rank from each rank's owned rows: the
        fields as bytes, the rows it does not own zeroed, summed by one
        ``all_reduce`` (each byte has one nonzero contributor)."""
        L = own.shape[0]
        parts = [(n, v.dtype, v.shape,
                  v.reshape(L, -1).contiguous().view(torch.uint8))
                 for n, v in rows.items()]
        flat = torch.cat([p[3] for p in parts], dim=1)
        flat = torch.where(own[:, None], flat, 0)
        dist.all_reduce(flat, group=self.group)
        out, at = {}, 0
        for n, dt, shape, p in parts:
            w = p.shape[1]
            out[n] = flat[:, at:at + w].contiguous().view(dt).reshape(shape)
            at += w
        return out

    def forward_points(self):
        """The context of a learner's forward on the rank's share: above one
        rank it records the forward's cast points
        (``models.actor_critic.cast_points``) for ``grads``; else it yields
        None."""
        return cast_points() if self.n > 1 else contextlib.nullcontext()

    def grads(self, loss: torch.Tensor, params: dict, points, metrics: dict):
        """The whole batch's gradient for ``params`` from the rank's share
        of ``loss``, and the learner ``metrics`` summed over the ranks: one
        ``all_reduce`` of one flat buffer. With ``points`` (from
        ``forward_points``) the shares' float32 gradients at the cast
        points are summed and then rounded, each once to its cast's dtype,
        as the unsharded learner rounds the whole batch's, and carried back
        to the parameters; rounding each share before the sum would not be
        the unsharded rounding."""
        at = [p for p, _ in points] if points else list(params.values())
        g = torch.autograd.grad(loss, at, retain_graph=bool(points))
        if self.mesh is not None:
            vals = list(g) + list(metrics.values())
            flat = torch.cat([v.reshape(-1) for v in vals])
            dist.all_reduce(flat, group=self.group)
            out = [p.view_as(v) for p, v in zip(
                flat.split([v.numel() for v in vals]), vals)]
            g, metrics = out[:len(g)], dict(zip(metrics, out[len(g):]))
        if points:
            g = torch.autograd.grad(at, list(params.values()), grad_outputs=[
                x.to(dt).float() for x, (_, dt) in zip(g, points)])
        return dict(zip(params, g)), metrics

    def reduce_actor(self, metrics: dict) -> dict:
        """Actor metrics over every rank: the env sums and mean parts
        summed (epsilon is the same everywhere), one ``all_reduce``."""
        summed = {m: metrics[m] for m in ("mean_reward", "episodes_done",
                                          "lines_cleared") if m in metrics}
        return dict(metrics, **self.all_reduce(summed))

    @staticmethod
    def part_mean(x: torch.Tensor, size: int) -> torch.Tensor:
        """The rank's part of a mean over ``size`` global rows: the sum of
        its rows over ``size``, so that each row's gradient is the one the
        whole mean gives it (``x.mean()`` itself when it holds them all)."""
        return x.mean() if x.shape[0] == size else x.sum() / size

    def all_reduce(self, metrics: dict) -> dict:
        """Scalar metrics summed over the ranks, one ``all_reduce``."""
        if self.mesh is None or not metrics:
            return metrics
        v = torch.stack(list(metrics.values()))
        dist.all_reduce(v, group=self.group)
        return dict(zip(metrics, v.unbind()))


# the round-2 API name
dqn_state_sharding = train_state_sharding
