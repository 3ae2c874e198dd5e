"""Drive the port's DQN trainer (``train/dqn.py`` ``make_train``) as
``run_dqn --replay-layout obs-ring`` does: ``train_chunk_fn(state, T)`` a
call, T actor steps of B envs and one learner update per ``learn_every`` of
them, synchronised at its end.

The configuration's ``env`` holds the env's kwargs and, under ``agent``,
the trainer's settings (``DQNConfig``'s fields, ``auto_reset``) and the
network's widths, which set-up checks against the network the trainer
builds. Traffic parameters: ``batch`` (B; below the agent's ``num_envs``,
a CPU run's size, the per-env sizes kept: ``model_flops.at_batch``),
``steps_per_call`` (T, a multiple of ``learn_every``), ``compare_envs``
and ``trace_calls``.

Set-up: the trainer built and initialised from the seed, calls until the
first learner update has run (``learn_starts`` and the obs ring's gate),
then one warm-up call. After every call the compared envs' new ring slots
(action, reward, done and the stacked row) come to the host.

What decides ``correct``:

- The env. The NumPy reference game and raster replay each compared env
  from the trainer's env key (the first of the three keys the seed's key
  splits into), every actor step of the run, set-up's included, on the
  actions the agent took; every differing pixel, stacked row, reward and
  done counts (limit 0).
- The learner. After the window, the next actor step and learner update
  run through the trainer's own ``actor_half`` / ``learner_half``, with
  hooks that only record: the draw of the batch (``sample_draw``: slot,
  env, IS weights), the network's forwards (the online logits on s and
  s'), the TD errors that go to the priority write-back
  (``update_priority_block``) and the clipped gradients and Adam's state
  at Adam (``adam_update``). The plain float32 reference
  (``perfbench/reference_torch/rainbow.py``) computes the same update on
  the card from the raw ring rows of the drawn (slot, env), the parameters,
  the target and the learner's noise key; each quantity counts the
  elements outside its tolerance (``TOL``, with its reason), limit 0. The
  logits, cross-entropies and gradients are held in units of how far the
  reference itself moves on this batch when computed in bf16, the
  configuration's precision (``yardstick``).
  ``--control 1``: the reference's projection shifted by one atom.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import common
from .. import model_flops
from ..reference import raster, surfaces, threefry
from ..reference.game import Games

# Tolerances of the learner comparison, each with its reason. The program
# computes each layer's operands and outputs in bf16 (8 bits of mantissa) on
# float32 parameters, the reference everything in float32. How far bf16
# moves an update depends on the batch: a trained network's gradient is a
# small sum of large terms, and bf16's rounding, of the weights above all,
# can move a trunk gradient by 40% of its norm. So the logits, the
# cross-entropy and the gradients are held in units of the yardstick
# (``yardstick``): how far the reference itself moves when computed in
# bf16 (``dtype``) on the same batch and device.
TOL = {
    # Each online C51 logit on s, off by at most this many times the
    # largest logit error of the reference in bf16: over 19 batches on the
    # card the program read 0.77-1.13, the reference in float8 e4m3 4.4 and
    # more.
    "logits": 2.5,
    # The reference's Q(s', .) of the program's double-DQN choice, below its
    # best, as a share of the support's span: the program's Q-values sit up
    # to 0.0067 of the span from the reference's, so two actions that close
    # may swap; a choice by the wrong network or sign leaves the best action
    # by the spread of Q.
    "selection": 0.02,
    # Each row's cross-entropy, off by at most this many times the largest
    # logit error of the reference in bf16: to first order it moves by
    # sum_z (p_z - m_z) d_z, at most twice the largest logit error d; over
    # 19 batches the program read 0.19-1.00, float8 2.63 and more, the
    # projection shifted by one atom 35.6 and more.
    "loss": 2.0,
    # Each row's new priority against (|ce| + eps)^alpha of the program's own
    # cross-entropy, relative: float32 powers in two orders, an ulp or two.
    "priority": 1e-5,
    # Each clipped gradient tensor, the L2 norm of the difference in units
    # of the reference's own in bf16: over 19 batches the program read
    # 0.99-1.11, float8 22.2 and more, the shifted projection 53.5 and
    # more.
    "grads": 6.0,
}
# Adam on the program's clipped gradients, element by element: both float32,
# only the order of a few elementwise ops differs; for the parameters in
# units of the learning rate, for the moments of each tensor's largest.
# (Adam divides by the root of the second moment, so a near-zero gradient's
# rounding becomes a step of order lr: Adam is held on the program's own
# gradients, which are held to the reference's above.)
TOL_ADAM = {"params": 1e-2, "moments": 1e-4}


class Entry:
    def __init__(self, env_kwargs: dict, mix: dict, seeds, device):
        self.env_kwargs = {k: v for k, v in env_kwargs.items()
                           if k != "agent"}
        self.agent = model_flops.at_batch(env_kwargs["agent"],
                                          int(mix["batch"]))
        self.seeds = seeds
        self.device = device
        self.batch = self.agent["num_envs"]
        self.T = int(mix["steps_per_call"])
        if self.T % self.agent["learn_every"]:
            raise ValueError(f"steps_per_call {self.T} is not a multiple of "
                             f"learn_every {self.agent['learn_every']}")
        self.steps_per_call = self.batch * self.T
        self.sample = common.sample_envs(self.batch, int(mix["compare_envs"]),
                                         seeds.sample)
        self.got = []
        self.steps = 0

    # -- the program --------------------------------------------------------
    def setup(self) -> None:
        import torch
        from gym_simpletetris_tpu_torch.core.config import EnvConfig
        from gym_simpletetris_tpu_torch.train import dqn
        fields = {f.name for f in dataclasses.fields(dqn.DQNConfig)}
        cfg = dqn.DQNConfig(
            env=EnvConfig(**self.env_kwargs,
                          auto_reset=self.agent["auto_reset"]),
            **{k: v for k, v in self.agent.items() if k in fields})
        self.cfg, self.dqn = cfg, dqn
        init_fn, _, self.chunk, self.net = dqn.make_train(cfg, self.device)
        self.state = init_fn(self.seeds.env)
        _check_network(self.net, self.state.params, self.agent)
        self.slots = cfg.buffer_capacity // cfg.num_envs
        self.idx = torch.as_tensor(self.sample, device=self.device)
        for _ in range(self.slots // self.T + 2):
            self.call()
            if int(self.state.learn_steps) > 0:
                break
        else:
            raise RuntimeError("learning never started")
        self.call()

    def call(self):
        import torch
        self.state, _ = self.chunk(self.state, self.T)
        common.synchronize(self.device)
        rp, B = self.state.replay, self.batch
        slots = (self.steps + torch.arange(self.T, device=self.device)) \
            % self.slots
        flat = (slots[:, None] * B + self.idx[None, :]).reshape(-1)
        take = lambda buf: buf.reshape(self.slots * B, -1).index_select(
            0, flat).reshape(self.T, len(self.sample), -1).cpu().numpy()
        self.got.append(dict(frame=take(rp.frame),
                             action=take(rp.action)[..., 0],
                             reward=take(rp.reward)[..., 0],
                             done=take(rp.done)[..., 0]))
        self.steps += self.T
        return None

    def collect(self) -> None:
        """The next actor step and learner update with their inputs and
        outputs recorded (``learner_record``); the rest of the device's
        memory freed."""
        self.learn = learner_record(self.dqn, self.cfg, self.chunk, self.net,
                                    self.state)
        self.state = self.chunk = self.net = self.idx = None

    # -- the comparison -------------------------------------------------------
    def check(self, control: bool):
        n = dict(pixel=0, stack=0, reward=0, done=0)
        got = {k: np.concatenate([g[k] for g in self.got])
               for k in ("frame", "action", "reward", "done")}
        want = replay_envs(self.env_kwargs, self.sample, self.seeds.env,
                           got["action"], self.agent["frame_stack"])
        for k in ("reward", "done"):
            n[k] = common.mismatches(got[k], want[k])
        diff = got["frame"] != want["frame"].reshape(got["frame"].shape)
        n["pixel"], n["stack"] = int(diff.sum()), int(diff.any(-1).sum())
        checks = common.checks({f"{k}_mismatches": v for k, v in n.items()})
        readings, out = learner_checks(self.learn, self.cfg,
                                       shift=1 if control else 0)
        checks.update(common.checks(out))
        compared = dict(calls=len(self.got), envs=len(self.sample),
                        env_steps=self.steps * len(self.sample),
                        learner_rows=len(self.learn["actions"]), **readings)
        return checks, compared


def learner_record(dqn, cfg, chunk, net, state) -> dict:
    """One actor step and learner update of the trainer from ``state``
    through its own halves, recorded (``record_learner``): the update's
    inputs (parameters, target, Adam's state, the learner's noise key, IS
    weights, the raw ring rows of the drawn (slot, env): the stacked rows at
    the slot and n slots on, the action, the n rewards and dones) and its
    outputs (the online logits on s, the program's double-DQN choice and
    its Q-values, each row's cross-entropy and new priority, the clipped
    gradients, parameters and moments after Adam)."""
    import torch
    state, (k_sample, k_nlearn, _) = chunk.actor_half(state)
    rec = record_learner(dqn, net, lambda: chunk.learner_half(
        state, k_sample, k_nlearn))
    after, slot, env = rec["state"], rec["slot"], rec["env"]
    rp, n = after.replay, cfg.n_step
    S, B = rp.frame.shape[:2]
    ahead = lambda j: ((slot + j) % S).long() * B + env.long()
    row = lambda buf, j: buf.reshape(S * B, -1).index_select(0, ahead(j))
    sup = dqn.support_f32(cfg.v_min, cfg.v_max, cfg.num_atoms,
                          rp.frame.device)
    # the program's double-DQN choice, by its own functions
    q_next = dqn._sum_f32(dqn._softmax(rec["forwards"][2]) * sup)
    return dict(
        params=state.params, target=state.target_params,
        mu=state.opt_state["mu"], nu=state.opt_state["nu"],
        count=int(state.opt_state["count"]), noise_key=k_nlearn.cpu(),
        rows=row(rp.frame, 0), next_rows=row(rp.frame, n),
        actions=row(rp.action, 0)[:, 0],
        rewards=torch.cat([row(rp.reward, j) for j in range(n)], 1),
        dones=torch.cat([row(rp.done, j) for j in range(n)], 1),
        weights=rec["weights"], logits=rec["forwards"][0],
        a_star=torch.argmax(q_next, dim=1), q_next=q_next, ce=rec["ce"],
        priorities=rp.priority.reshape(-1)[ahead(0)],
        grads=rec["grads"], params_after=after.params,
        mu_after=after.opt_state["mu"], nu_after=after.opt_state["nu"])


def learner_checks(learn: dict, cfg, **controls):
    """The plain reference's update on ``learn``'s inputs against the
    program's outputs (``learner_record``), on their device: (readings,
    the largest error of each quantity in the units of ``TOL``, Adam's in
    units of its tolerance, and the logits' and gradients' relative to the
    reference's own size; the counts of logits, rows, gradient tensors and
    Adam's elements outside their tolerances). ``controls`` go to the
    reference (``act_round``, ``shift``, ``dueling_mean``); the yardstick
    is the sound reference's."""
    import torch
    from ..reference_torch import rainbow
    L = learn
    frame = int(math.isqrt(L["rows"].shape[1] // cfg.frame_stack))
    hp = dict(gamma=cfg.gamma, v_min=cfg.v_min, v_max=cfg.v_max,
              num_atoms=cfg.num_atoms, frame_size=frame,
              frame_stack=cfg.frame_stack, max_grad_norm=cfg.max_grad_norm,
              lr=cfg.lr, per_alpha=cfg.per_alpha, per_eps=cfg.per_eps)

    def update(**kw):
        return rainbow.learner_update(
            L["params"], L["target"], L["mu"], L["nu"], L["count"],
            L["rows"], L["next_rows"], L["actions"], L["rewards"],
            L["dones"], L["weights"], L["noise_key"], hp, a_star=L["a_star"],
            **kw)
    ref = update(**controls)
    plain = update() if controls else ref
    errs = learner_errors(L, ref, yardstick(plain, update(
        dtype=torch.bfloat16)), cfg)
    with rainbow.float32_matmuls():
        params, mu, nu = rainbow.adam(L["params"], L["grads"], L["mu"],
                                      L["nu"], L["count"], cfg.lr)
    readings = {f"{k}_err": float(e.max()) for k, e in errs.items()}
    span = cfg.v_max - cfg.v_min
    readings["q_next_err"] = float((L["q_next"] - ref["q_next"]).abs().max()
                                   / span)
    readings["logits_rel_err"] = float((L["logits"] - ref["logits"]).abs()
                                       .max() / plain["logits"].abs().max())
    readings["grads_rel_err"] = max(float((L["grads"][k] - g).norm()
                                          / plain["grads"][k].norm())
                                    for k, g in ref["grads"].items())
    out = {f"{k}_out_of_tol": int((e > TOL[k]).sum()) for k, e in errs.items()}
    adam = []
    for k in params:
        adam.append(((L["params_after"][k] - params[k]).abs()
                     / (cfg.lr * TOL_ADAM["params"])).reshape(-1))
        for m, want in (("mu", mu), ("nu", nu)):
            scale = want[k].abs().max().clamp(min=1e-30)
            adam.append(((L[f"{m}_after"][k] - want[k]).abs()
                         / (scale * TOL_ADAM["moments"])).reshape(-1))
    adam = torch.cat(adam)
    readings["adam_err_in_tol"] = float(adam.max())
    out["adam_out_of_tol"] = int((adam > 1).sum())
    return readings, out


def yardstick(plain: dict, bf16: dict) -> dict:
    """How far the reference's update moves when computed in bf16: the
    largest logit error and each gradient tensor's L2 error, each at least
    one bf16 step (2^-8) of the float32 quantity's largest element or
    norm."""
    step = 2.0 ** -8
    logits = (bf16["logits"] - plain["logits"]).abs().max().clamp(
        min=step * plain["logits"].abs().max())
    return dict(logits=logits,
                grads={k: (bf16["grads"][k] - g).norm().clamp(
                    min=step * g.norm()) for k, g in plain["grads"].items()})


def learner_errors(got: dict, ref: dict, scale: dict, cfg) -> dict:
    """Each quantity of the update ``got`` (logits, a_star, ce, priorities,
    grads) against the reference's ``ref``, in the units of ``TOL``."""
    import torch
    from ..reference_torch import rainbow
    rows = torch.arange(len(got["a_star"]), device=got["a_star"].device)
    own = rainbow.new_priorities(got["ce"], cfg.per_alpha, cfg.per_eps)
    return {
        "logits": (got["logits"] - ref["logits"]).abs() / scale["logits"],
        "selection": (ref["q_next"].max(1).values
                      - ref["q_next"][rows, got["a_star"]])
        / (cfg.v_max - cfg.v_min),
        "loss": (got["ce"] - ref["ce"]).abs() / scale["logits"],
        "priority": (got["priorities"] - own).abs() / own,
        "grads": torch.stack([(got["grads"][k] - g).norm() / scale["grads"][k]
                              for k, g in ref["grads"].items()]),
    }


def _check_network(net, params: dict, agent: dict) -> None:
    """The trainer's network has the configuration's widths, compute and
    parameter dtypes and noise scale (its fresh sigmas are sigma0 /
    sqrt(fan in))."""
    import torch
    w = agent["width_mult"]
    want = {f"conv{i + 1}.weight": (c * w, None, k, k)
            for i, (c, k, _) in enumerate(agent["convs"])}
    want["dense.weight_mu"] = (agent["dense"] * w, None)
    want["C51Head_0.value.weight_mu"] = (agent["num_atoms"],
                                         agent["dense"] * w)
    want["C51Head_0.advantage.weight_mu"] = (
        agent["num_actions"] * agent["num_atoms"], agent["dense"] * w)
    for name, shape in want.items():
        got = tuple(params[name].shape)
        if len(got) != len(shape) or any(s is not None and s != g
                                         for s, g in zip(shape, got)):
            raise ValueError(f"{name}: {got}, the configuration says {shape}")
    if net.dtype != getattr(torch, agent["compute_dtype"]):
        raise ValueError(f"compute dtype {net.dtype}")
    for name, p in params.items():
        if p.dtype != getattr(torch, agent["param_dtype"]):
            raise ValueError(f"{name} is {p.dtype}")
        if name.endswith("weight_sigma"):
            s = agent["noisy_sigma0"] / math.sqrt(p.shape[1])
            if not torch.allclose(p, torch.full_like(p, s)):
                raise ValueError(f"{name} is not sigma0 / sqrt(fan in)")


def record_learner(dqn, net, run) -> dict:
    """``run()`` (one learner update) with hooks that record what it
    computes and change none of it: the batch's draw, the network's
    outputs, the TD errors of the priority write-back, Adam's input."""
    rec = {"forwards": []}
    real = {n: getattr(dqn, n) for n in (
        "sample_draw", "update_priority_block", "adam_update")}

    def sample_draw(*args, **kw):
        out = real["sample_draw"](*args, **kw)
        rec["slot"], rec["env"], rec["weights"] = out
        return out

    def update_priority_block(rs, slot, env, td_abs, *args):
        rec["ce"] = td_abs.detach().clone()
        return real["update_priority_block"](rs, slot, env, td_abs, *args)

    def adam_update(grads, opt_state, lr):
        rec["grads"] = {k: g.detach().clone() for k, g in grads.items()}
        return real["adam_update"](grads, opt_state, lr)

    hook = net.register_forward_hook(
        lambda m, args, out: rec["forwards"].append(out.detach().clone()))
    for name, fn in (("sample_draw", sample_draw),
                     ("update_priority_block", update_priority_block),
                     ("adam_update", adam_update)):
        setattr(dqn, name, fn)
    try:
        rec["state"], _ = run()
    finally:
        hook.remove()
        for name, fn in real.items():
            setattr(dqn, name, fn)
    return rec


def replay_envs(config: dict, sample, seed: int, actions: np.ndarray,
                stack: int) -> dict:
    """The reference's replay of the envs ``sample`` of the trainer seeded
    with ``seed``, on ``actions`` [steps, len(sample)]: per step the
    stacked row the actor saw (uint8 [steps, S, 84, 84, stack]), the reward
    and the done. The env key is the first of the seed key's three; its
    reset splits it once, each step twice (the spawn draw, the auto-reset's
    draw for the games that died)."""
    sample = np.asarray(sample, np.int64)
    g = Games(config, len(sample))
    key, draw = threefry.split(threefry.split(threefry.key_from_seed(seed))[0])
    g.clear(np.ones(len(sample), bool), threefry.bits([draw], sample)[0])
    image = lambda boards: raster.grayscale(boards, surfaces.OBS_SIZE).astype(
        np.uint8)
    frames = np.repeat(image(g.board)[..., None], stack, axis=-1)
    steps = len(actions)
    out = dict(frame=np.zeros((steps,) + frames.shape, np.uint8),
               reward=np.zeros((steps, len(sample)), np.float32),
               done=np.zeros((steps, len(sample)), bool))
    for t in range(steps):
        out["frame"][t] = frames
        key, spawn = threefry.split(key)
        key, again = threefry.split(key)
        emitted, out["reward"][t], out["done"][t] = g.step(
            actions[t], threefry.bits([spawn], sample)[0])
        d = out["done"][t]
        g.clear(d, threefry.bits([again], sample)[0])
        emitted[d] = 0
        new = image(emitted)[..., None]
        frames = np.where(d[:, None, None, None],
                          np.repeat(new, stack, axis=-1),
                          np.concatenate([frames[..., 1:], new], axis=-1))
    return out
