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
run on a (``data``, ``model``) mesh by these placements, one process per
card. ``DataParallel`` is their plumbing of both axes: the rank's env block
and learner share over ``data``, and their collectives; over ``model``, the
layers' ``ModelShard`` (``models.actor_critic.shard_layers``: a split
layer gathers its output blocks forward and sums its input gradients
backward, so the model-axis reductions run inside autograd) and the rank's
blocks of the parameters. Every weight block holds the same rows in
``params``, ``target_params`` and Adam's ``mu`` / ``nu``; ``sharded_weights``
reads which weights are split from a parameter dict alone, whole or
blocked, by the size of each weight's bias. ``gather_train_state`` /
``shard_train_state`` (and ``utils/checkpoint.py`` through them) gather and
cut a state along both axes, so a checkpoint is the same file at every
topology.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor.placement_types import Replicate, Shard

from ..models.actor_critic import ModelShard, cast_points
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, all_gather_cat, block,
                             data_axis, model_axis as _model_axis,
                             shard_dims, state_sharding)

_KERNEL_LEAVES = ("weight", "weight_mu", "weight_sigma")


def mesh_axes(mesh_shape) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh_shape, Mapping):
        return dict(mesh_shape)
    names = mesh_shape.mesh_dim_names or (DATA_AXIS,)
    return dict(zip(names, mesh_shape.shape))


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
    split = model_paths(state, axes[model_axis]) if model_axis in axes \
        else set()
    out = {}
    for path, _ in leaves(state):
        spec = {DATA_AXIS: data[path]}
        if path in split:
            spec[model_axis] = Shard(0)
        out[path] = tuple(spec.get(a, Replicate()) for a in axes)
    return out


def data_dims(state) -> dict:
    """{path: the dim sharded over the data axis, or None} of every tensor
    of a trainer state: the data axis of ``train_state_sharding``, the env
    rows' layout read from the state itself."""
    env = (state_sharding(state.env_state) if hasattr(state, "env_state")
           else {})
    return shard_dims(_data_placements(state, env))


def sharded_weights(params: dict, n: int) -> set:
    """The names in a parameter dict (or its gradients' or Adam moments')
    of the weights split over a model axis of size ``n``: a weight (or a
    NoisyDense's ``weight_mu`` / ``weight_sigma``) of 2 or more dims whose
    layer's output width, the size of its whole bias, divides by n. It
    reads a whole dict and a rank's blocks alike."""
    if n == 1:
        return set()
    out = set()
    for name, w in params.items():
        mod, _, leaf = name.rpartition(".")
        if leaf in _KERNEL_LEAVES and w.dim() >= 2:
            bias = (mod + "." if mod else "") + leaf.replace("weight", "bias")
            if params[bias].numel() % n == 0:
                out.add(name)
    return out


def model_paths(state, n: int) -> set:
    """The paths of a trainer state's weights split over a model axis of
    size ``n`` (dim 0 of each): in ``params``, ``target_params`` and Adam's
    ``mu`` / ``nu``."""
    dicts = [(f,) for f in ("params", "target_params") if hasattr(state, f)]
    if getattr(state, "opt_state", None) is not None:
        dicts += [("opt_state", "mu"), ("opt_state", "nu")]
    out = set()
    for path in dicts:
        d = getattr(state, path[0])
        d = d[path[1]] if len(path) > 1 else d
        out.update(path + (name,) for name in sharded_weights(d, n))
    return out


def _once(fn):
    """``fn`` for ``map_leaves`` run once per tensor object: a tensor held
    at two paths (the target's, the parameters' after a sync) stays one
    tensor, as a checkpoint stores it."""
    memo = {}

    def one(p, x):
        if id(x) not in memo:
            memo[id(x)] = (x, fn(p, x))
        return memo[id(x)][1]
    return one


def gather_train_state(state, mesh, model_axis: str = MODEL_AXIS):
    """The global trainer state from every rank's block, on every rank: each
    data-sharded tensor all-gathered along its axis, each weight block
    along dim 0 over the model axis, the replicated ones kept as they are
    (the same objects)."""
    group, _, _ = data_axis(mesh)
    mgroup, _, m = _model_axis(mesh, model_axis)
    dims, split = data_dims(state), model_paths(state, m)

    def whole(p, x):
        if dims[p] is not None:
            x = all_gather_cat(x, group, dims[p])
        return all_gather_cat(x, mgroup, 0) if p in split else x

    out = map_leaves(state, _once(whole))
    if hasattr(out, "env_state"):
        out = dataclasses.replace(
            out, env_state=out.env_state.replace(env_offset=0))
    return out


def shard_train_state(state, mesh, model_axis: str = MODEL_AXIS):
    """This rank's block of a global trainer state (a checkpoint's), along
    both axes."""
    _, rank, n = data_axis(mesh)
    _, mrank, m = _model_axis(mesh, model_axis)
    dims, split = data_dims(state), model_paths(state, m)

    def own(p, x):
        if dims[p] is not None:
            x = block(x, dims[p], rank, n)
        return block(x, 0, mrank, m) if p in split else x

    out = map_leaves(state, _once(own))
    if hasattr(out, "env_state"):
        es = out.env_state
        out = dataclasses.replace(out, env_state=es.replace(
            env_offset=rank * es.batch_size))
    return out


class DataParallel:
    """The plumbing of a trainer over a mesh. The data axis: the rank's
    block of ``num_envs`` and share of a ``learn_batch``, and the
    collectives. The model axis (``model_axis``, where the mesh has it and
    its size is above 1): ``model``, the layers' ``ModelShard``
    (``models.actor_critic.shard_layers`` splits a network by it), and
    ``own``, the rank's blocks of the parameters. Without a mesh every method is the unsharded
    trainer's identity."""

    def __init__(self, mesh, device, num_envs: int, learn_batch: int = 0,
                 model_axis: str = MODEL_AXIS):
        self.mesh = mesh
        self.group, self.rank, self.n = None, 0, 1
        self.model = None
        if mesh is not None:
            if torch.device(device).type != mesh.device_type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device_type}")
            self.group, self.rank, self.n = data_axis(mesh)
            group, rank, m = _model_axis(mesh, model_axis)
            if m > 1:
                self.model = ModelShard(group, rank, m)
        for what, v in (("num_envs", num_envs), ("learn_batch", learn_batch)):
            if v % self.n:
                raise ValueError(f"{what} {v} must divide by the mesh's data "
                                 f"axis ({self.n})")
        self.B, self.L = num_envs, learn_batch
        self.b, self.ls = num_envs // self.n, learn_batch // self.n
        self.offset = self.rank * self.b
        # the rank's block of a per-env draw
        self.block = (0, self.offset, self.offset + self.b) if mesh else None

    def own(self, params: dict) -> dict:
        """The rank's blocks of whole parameters: each split weight's rows
        of the rank (``sharded_weights``), every other tensor as it is."""
        if self.model is None:
            return params
        split = sharded_weights(params, self.model.n)
        return {k: block(v, 0, self.model.rank, self.model.n)
                if k in split else v for k, v in params.items()}

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
