"""Checkpoints of the PyTorch port (counterpart of
``gym_simpletetris_tpu.utils.checkpoint``, which uses orbax).

- ``save_checkpoint`` / ``restore_checkpoint``: a whole trainer state in
  one ``torch.save`` file. A ``PPOState``: params, Adam moments and step,
  the env state with its threefry key, the current observation, the
  trainer key and the update count. A ``DQNState``: params, target params,
  Adam state, the replay ring (the legacy ring, or the frame / obs ring
  with its layout: buffers, priorities, pointer and fill), the n-step
  window, the env state, the observation (stack), the key and the step
  counters. An ``ESState``: theta, the key and the generation. Training is
  a function of that state alone, so a resumed run is bit-identical to one
  that never stopped. ``restore_checkpoint`` tells the states and the ring
  layouts apart by what the file holds. Tensors are written as contiguous
  host copies (one per tensor object), so the file depends on the state's
  values alone.
- Sharded states (``mesh=``, a data axis and perhaps a model axis):
  ``save_checkpoint`` gathers the global state from every rank's blocks
  (``train.sharding.gather_train_state``: the env blocks over ``data``, the
  weight blocks over ``model``) and the rank at index 0 of every axis
  writes it: for the same state, byte for byte the file of the unsharded
  run; ``restore_checkpoint`` gives each rank its blocks of it, at any
  mesh whose axes divide the batch and the split widths.
- ``load_flax_params``: flax parameters (``ActorCritic`` or a Q-network)
  from an ``.npz`` whose keys are the flax paths joined by ``/`` (as
  ``artifacts/ppo_lineclear_params.npz`` holds them), as a state_dict.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def _fields(obj, memo: dict):
    """A dataclass's fields as a dict, nested state dataclasses and dicts
    too, every tensor as a contiguous host copy (one per tensor object)."""
    if isinstance(obj, torch.Tensor):
        if id(obj) not in memo:
            memo[id(obj)] = obj.detach().to(
                "cpu", memory_format=torch.contiguous_format, copy=True)
        return memo[id(obj)]
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name), memo)
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _fields(v, memo) for k, v in obj.items()}
    return obj


def save_checkpoint(path: str, state, mesh=None) -> str:
    """Write ``state`` (a ``PPOState``, ``DQNState`` or ``ESState``) to the
    file ``path``. With ``mesh``, every rank calls it with its block; the
    global state is gathered and rank 0 writes it."""
    path = os.path.abspath(path)
    if mesh is not None:
        from ..train.sharding import gather_train_state
        state = gather_train_state(state, mesh)
        if any(mesh.get_coordinate()):
            _barrier(mesh)
            return path
    tmp = path + ".tmp"
    torch.save(_fields(state, {}), tmp)
    os.replace(tmp, path)            # a crash mid-write keeps the old file
    if mesh is not None:
        _barrier(mesh)
    return path


def _barrier(mesh) -> None:
    """Every rank of the mesh has arrived: a barrier over each axis's group
    in turn (passing the last means every rank passed the first)."""
    import torch.distributed as dist
    for dim in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(dim))


def restore_checkpoint(path: str, device="cuda", mesh=None):
    """Read a state written by ``save_checkpoint`` onto ``device``, the card
    unless ``device="cpu"`` (a CUDA request without a card raises): a file
    that holds ``theta`` is an ``ESState``, one that holds a replay ring a
    ``DQNState`` (a ring of ``frame`` rows the frame / obs ring, else the
    legacy ring), any other a ``PPOState``. With ``mesh``, this rank's block
    of the saved global state."""
    if mesh is None:
        return _restore(path, device)
    # the rank's block, cut on the host and then moved
    from ..api.env import check_device
    from ..train.sharding import map_leaves, shard_train_state
    device = check_device(device)
    return map_leaves(shard_train_state(_restore(path, "cpu"), mesh),
                      lambda p, x: x.to(device))


def _restore(path: str, device):
    from ..api.env import check_device
    d = torch.load(os.path.abspath(path), map_location=check_device(device),
                   weights_only=True)
    if "theta" in d:
        from ..train.es import ESState
        return ESState(**d)
    from ..core.state import EnvState
    d["env_state"] = EnvState(**d["env_state"])
    if "replay" not in d:
        from ..train.ppo import PPOState
        return PPOState(**d)
    from ..train.dqn import DQNState
    from ..train.replay import FrameRingState, ReplayState
    r = d["replay"]
    if "frame" in r:
        d["replay"] = FrameRingState(**dict(
            r, base_shape=tuple(r["base_shape"])))
    else:
        d["replay"] = ReplayState(**dict(r, obs_shape=tuple(r["obs_shape"])))
    return DQNState(**d)


def load_flax_params(path: str) -> dict:
    """An ``.npz`` of flax parameters (keys like
    ``params/MlpTrunk_0/dense0/kernel``) -> the port's state_dict."""
    from ..models.actor_critic import params_from_flax
    tree = {}
    with np.load(path) as z:
        for name in z.files:
            *mods, leaf = name.split("/")
            node = tree
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = z[name]
    return params_from_flax(tree)
