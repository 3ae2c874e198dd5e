"""Bridges between the JAX package and its PyTorch port for the port's tests:
engine states, and flax parameter trees against the port's state_dicts.
Importing it puts torch on one CPU thread. It imports JAX only where a
bridge needs it, so the card's test files, on a machine without JAX, import
it too."""

import numpy as np
import torch

from gym_simpletetris_tpu_torch.core.state import (
    FIELDS, state_from_numpy, state_to_numpy)
from gym_simpletetris_tpu_torch.models.actor_critic import (
    _FLAX_LEAVES, params_from_flax)

# torch on one CPU thread in every port test (each tests/test_torch_*.py
# imports this module): the suite runs in several worker processes on one
# host, and each one's default of an intra-op thread per core oversubscribes
# it.
torch.set_num_threads(1)


def to_port(js, device="cpu"):
    """A JAX ``EnvState`` as the port's state."""
    return state_from_numpy({f: np.asarray(getattr(js, f)) for f in FIELDS},
                            device)


def assert_state_equal(js, ts, msg=""):
    """Every field of a JAX and a port state bitwise equal."""
    got = state_to_numpy(ts)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(js, f)),
                                      err_msg=f"state.{f} {msg}")


def flax_to_state_dict(tree) -> dict:
    """A flax parameter tree (jax or numpy leaves) -> the port's
    state_dict (``models.actor_critic.params_from_flax``)."""
    import jax
    return params_from_flax(jax.tree.map(np.asarray, tree))


def state_dict_to_flax(sd: dict, like) -> dict:
    """The port's state_dict -> a flax parameter tree shaped like ``like``
    (a flax tree of the same network), as numpy float32."""
    import jax
    want = flax_to_state_dict(like)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        mods = ["trunk" if p in ("MlpTrunk_0", "ConvTrunk_0") else p
                for p in path[:-1] if p != "params"]
        name, kernel = _FLAX_LEAVES[path[-1]]
        key = ".".join(mods + [name])
        assert key in want, key
        a = sd[key].detach().cpu().numpy().astype(np.float32)
        if kernel:
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        return a

    return walk(jax.tree.map(np.asarray, like), ())


def assert_bitwise(got: torch.Tensor, want, msg=""):
    """A port tensor and a JAX / numpy array equal bit for bit (floats by
    their bits), shapes included."""
    want = np.asarray(want)
    g = got.detach().cpu().numpy()
    assert g.shape == want.shape, (msg, g.shape, want.shape)
    if g.dtype == np.float32:
        g, want = g.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(g, want, err_msg=msg)

