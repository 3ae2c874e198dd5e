"""``train/sharding.py``'s path-assigned placements against the JAX
package's ``train_state_sharding`` on a (data 4, model 2) mesh, leaf by
leaf, for a DQNState on the legacy ring (PER, n-step window, noisy dueling
heads), a DQNState on the obs ring (conv trunk) and a PPOState: the flax
paths mapped to the port's state_dict names, a JAX spec on a kernel's last
(output) axis is the port's ``Shard(0)`` (``nn.Linear`` and conv weights
hold the output axis first), every data-axis spec the same axis. One
process, no world."""

import jax
import pytest
from jax.sharding import Mesh, PartitionSpec as P
from torch.distributed.tensor.placement_types import Replicate, Shard
import numpy as np

from gym_simpletetris_tpu import EnvConfig as JaxConfig
from gym_simpletetris_tpu.train import dqn as jax_dqn
from gym_simpletetris_tpu.train import ppo as jax_ppo
from gym_simpletetris_tpu.train import sharding as jax_sharding
from gym_simpletetris_tpu_torch import EnvConfig
from gym_simpletetris_tpu_torch.models.actor_critic import _FLAX_LEAVES
from gym_simpletetris_tpu_torch.train import dqn, ppo, sharding
import torch_dist_harness as H
import port_harness  # noqa: F401 (torch on one CPU thread)

AXES = {"data": 4, "model": 2}


def _names(path):
    return [str(getattr(k, "name", getattr(k, "key", getattr(k, "idx", k))))
            for k in path]


def _torch_path(names):
    """A JAX state's leaf path -> the port's."""
    head = names[0]
    if head in ("params", "target_params", "opt_state"):
        if head == "opt_state":
            at = next(i for i, n in enumerate(names) if n in ("mu", "nu",
                                                              "count"))
            if names[at] == "count":
                return ("opt_state", "count")
            head, names = f"opt_state.{names[at]}", names[at:]
        rest = [n for n in names[1:] if n != "params"]
        mods = ["trunk" if n in ("MlpTrunk_0", "ConvTrunk_0") else n
                for n in rest[:-1]]
        name = ".".join(mods + [_FLAX_LEAVES[rest[-1]][0]])
        return tuple(head.split(".")) + (name,)
    return tuple(names)


def _want(spec: P, ndim: int):
    """A JAX PartitionSpec -> the port's placements over (data, model)."""
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    out = []
    for axis in AXES:
        dims = [d for d, a in enumerate(spec) if a == axis]
        if not dims:
            out.append(Replicate())
        elif axis == "model":
            assert dims == [ndim - 1]           # a flax kernel's output axis
            out.append(Shard(0))
        else:
            out.append(Shard(dims[0]))
    return tuple(out)


def _cases():
    ekw = dict(auto_reset=True, reward_step=True, width=6, height=8)
    legacy = dict(H.CKPT_KW)
    return {
        "dqn_legacy": (dqn.DQNConfig(env=EnvConfig(**ekw), **legacy),
                       jax_dqn.DQNConfig(env=JaxConfig(**ekw), **legacy)),
        "dqn_obs_ring": (
            dqn.DQNConfig(env=EnvConfig(obs_type="grayscale", **ekw),
                          **H.RING_KW),
            jax_dqn.DQNConfig(env=JaxConfig(obs_type="grayscale", **ekw),
                              **H.RING_KW)),
        "ppo": (ppo.PPOConfig(env=EnvConfig(**ekw), **H.PPO_KW),
                jax_ppo.PPOConfig(env=JaxConfig(**ekw), **H.PPO_KW)),
    }


@pytest.mark.parametrize("name", ["dqn_legacy", "dqn_obs_ring", "ppo"])
def test_placements_match_jax(name):
    tcfg, jcfg = _cases()[name]
    if name == "ppo":
        t_init, j_init = ppo.make_ppo(tcfg, "cpu")[0], \
            jax_ppo.make_ppo(jcfg)[0]
    else:
        t_init, j_init = dqn.make_train(tcfg, "cpu")[0], \
            jax_dqn.make_train(jcfg)[0]
    tstate = t_init(0)
    abstract = jax.eval_shape(j_init, jax.random.PRNGKey(0))
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                ("data", "model"))
    jsh = jax_sharding.train_state_sharding(jcfg, mesh, abstract)
    got = sharding.train_state_sharding(tcfg, AXES, tstate)
    want = {}
    for (path, s), (_, leaf) in zip(
            jax.tree_util.tree_leaves_with_path(jsh),
            jax.tree_util.tree_leaves_with_path(abstract)):
        want[_torch_path(_names(path))] = _want(s.spec, len(leaf.shape))
    assert set(got) == set(want)
    for path in want:
        assert got[path] == want[path], (path, got[path], want[path])
    # the model axis is used at all, and the alias names the same rule
    assert any(p[1] == Shard(0) for p in got.values())
    assert sharding.dqn_state_sharding is sharding.train_state_sharding


def test_data_dims_follow_the_data_axis():
    tcfg, _ = _cases()["dqn_legacy"]
    state = dqn.make_train(tcfg, "cpu")[0](0)
    dims = sharding.data_dims(state)
    full = sharding.train_state_sharding(tcfg, {"data": 2}, state)
    for path, (pl,) in full.items():
        assert dims[path] == (pl.dim if isinstance(pl, Shard) else None)
    assert dims[("replay", "obs")] == 1 and dims[("obs",)] == 0
    assert dims[("env_state", "rows")] == 1 and dims[("key",)] is None
