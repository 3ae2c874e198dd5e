"""Checkpoints of the PyTorch port (counterpart of
``gym_simpletetris_tpu.utils.checkpoint``, which uses orbax).

- ``save_checkpoint`` / ``restore_checkpoint``: the whole ``PPOState`` in one
  ``torch.save`` file: params, Adam moments and step, the env state with its
  threefry key, the current observation, the trainer key and the update
  count. Training is a function of that state alone, so a resumed run is
  bit-identical to one that never stopped.
- ``load_flax_params``: flax ``ActorCritic`` parameters from an ``.npz``
  whose keys are the flax paths joined by ``/`` (as
  ``artifacts/ppo_lineclear_params.npz`` holds them), as a state_dict.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def save_checkpoint(path: str, state) -> str:
    """Write ``state`` (a ``PPOState``) to the file ``path``."""
    path = os.path.abspath(path)
    fields = lambda obj: {f.name: getattr(obj, f.name)
                          for f in dataclasses.fields(obj)}
    d = dict(fields(state), env_state=fields(state.env_state))  # no copies
    tmp = path + ".tmp"
    torch.save(d, tmp)
    os.replace(tmp, path)            # a crash mid-write keeps the old file
    return path


def restore_checkpoint(path: str, device="cpu"):
    """Read a ``PPOState`` written by ``save_checkpoint`` onto ``device``."""
    from ..core.state import EnvState
    from ..train.ppo import PPOState
    d = torch.load(os.path.abspath(path), map_location=device,
                   weights_only=True)
    d["env_state"] = EnvState(**d["env_state"])
    return PPOState(**d)


def load_flax_params(path: str) -> dict:
    """An ``.npz`` of flax ActorCritic parameters (keys like
    ``params/MlpTrunk_0/dense0/kernel``) -> an ``ActorCritic`` state_dict."""
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
