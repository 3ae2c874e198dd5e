"""Drive the port's ES trainer (``train/es.py`` ``make_es``) as ``run_es
--obs grayscale`` does: ``gen_step_fn(state)`` a call, one generation of
``pop`` members on ``pop * envs_per_member`` envs for ``horizon`` steps,
synchronised at its end.

The configuration's ``env`` holds the env's kwargs and, under ``agent``,
the trainer's settings (``ESConfig``'s fields, ``auto_reset``) and the
policy's widths, which set-up checks against the network the trainer
builds. Traffic parameters: ``batch`` (the envs, ``pop *
envs_per_member``; below the agent's, a CPU run's size with the envs a
member kept), ``steps_per_call`` (the horizon) and ``trace_calls``.

Set-up: the trainer built and initialised from the seed, then one warm-up
generation, recorded.

What decides ``correct``: set-up's generation, and after the window one
more generation from the timed path's state, each run through
``gen_step_fn`` with hooks that only record (``record_generation``; set-up's
record kept on the host through the window), are held to the NumPy game and
raster (``perfbench/reference/``) and the plain float32 reference
(``perfbench/reference_torch/es.py``), which draws its own keys from the
state's key:

- the env: every env replayed from the generation's reset key on the
  actions the program took; every differing pixel, reward and done counts;
- fitness: every member's, from the replayed rewards;
- eps: the reference's own normals, drawn in column blocks on the device,
  against the program's perturbations, both halves;
- Q-values: those of one antithetic pair (drawn from the seed) at every
  step, on the frames the program fed them, in units of the reference's
  own bf16 error on the same frames (``yardstick``);
- the update: theta' and the gradient from the program's fitness and the
  reference's eps, in units of the worst-case error of a float32 sum of
  the population's terms in any order (``bound``).

Each counts the elements outside its tolerance (``TOL``, with its reason),
limit 0. ``--control 1``: the reference computed below the configuration's
precision in the program's place (eps rounded to bf16, the update on that
eps, the Q-values through float8), through the same counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import common
from ..reference import raster, threefry
from ..reference.game import Games

# Tolerances of the comparison, each with its reason.
TOL = {
    # eps, in units in the last place: the reference's erfinv takes its log
    # in float64 where the program evaluates Cephes' float32 log1p; over
    # all 2**23 values u can take the two normals are at most 3 ulp apart
    # on the CPU (78,960 of them differ: 49,929 by 1, 23,110 by 2, 5,921
    # by 3), and one more ulp leaves room for the card's float64 log1p,
    # which may round its last bit otherwise. eps rounded to bf16 is
    # thousands of ulp away.
    "eps_ulps": 4,
    # Each Q-value of the pair, off by at most this many times the largest
    # error of the reference itself computed in bf16 on the same frames:
    # the program rounds each layer's operands and outputs to bf16 as the
    # bf16 reference does, in another order of summation.
    "q": 2.5,
    # Each element of the gradient and of theta', in units of a bound
    # (``generation_checks``): a float32 sum of n terms in any order is
    # within n u sum |terms| of the exact one (u = 2**-24); eps's 4 ulp,
    # the ranks' rounding and the scalings by 1 / (pop sigma), lr and
    # 1 - lr wd, each in float32, add a few u of their terms.
    "update": 1.0,
}


class Entry:
    def __init__(self, env_kwargs: dict, mix: dict, seeds, device):
        self.env_kwargs = {k: v for k, v in env_kwargs.items()
                           if k != "agent"}
        self.agent = env_kwargs["agent"]
        self.seeds = seeds
        self.device = device
        self.k_env = int(self.agent["envs_per_member"])
        self.batch = int(mix["batch"])
        self.pop = self.batch // self.k_env
        if self.pop * self.k_env != self.batch or self.pop % 2:
            raise ValueError(f"batch {self.batch} is not an even population "
                             f"of {self.k_env} envs a member")
        self.horizon = int(mix["steps_per_call"])
        self.steps_per_call = self.batch * self.horizon
        self.pair = seeds.sample % (self.pop // 2)

    # -- the program --------------------------------------------------------
    def setup(self) -> None:
        from gym_simpletetris_tpu_torch.core.config import EnvConfig
        from gym_simpletetris_tpu_torch.train import es
        fields = {f.name for f in dataclasses.fields(es.ESConfig)}
        agent = dict(self.agent, pop_size=self.pop, horizon=self.horizon)
        cfg = es.ESConfig(
            env=EnvConfig(**self.env_kwargs, auto_reset=agent["auto_reset"]),
            **{k: v for k, v in agent.items() if k in fields})
        self.cfg, self.es = cfg, es
        init_fn, self.gen, self.net = es.make_es(cfg, self.device)
        state = init_fn(self.seeds.env)
        _check_network(self.net, state.theta, self.agent)
        self.recs = [record_generation(es, self.gen, state, self.pair,
                                       cfg.sigma, host=True)]
        self.state = self.recs[0].pop("state")

    def call(self):
        self.state, _ = self.gen(self.state)
        common.synchronize(self.device)
        return None

    def collect(self) -> None:
        """One more generation, recorded; the rest of the device's memory
        freed."""
        self.recs.append(record_generation(self.es, self.gen, self.state,
                                           self.pair, self.cfg.sigma))
        self.recs[-1].pop("state")
        self.state = self.gen = self.net = None

    # -- the comparison -------------------------------------------------------
    def check(self, control: bool):
        """Both recorded generations against the references: the counts
        summed, each reading the larger of the two."""
        counts, readings = {}, {}
        for rec in self.recs:
            envs = replay_envs(self.env_kwargs, rec["keys"][1],
                               rec["actions"], rec["obs"], rec["rewards"],
                               rec["dones"], self.device)
            fit = _fitness(envs.pop("rewards"), self.k_env)
            envs["pixel"] += rec["obs_not_u8"]
            envs["fitness"] = common.mismatches(rec["fitness"], fit)
            got, out = generation_checks(rec, self.cfg, self.agent, control,
                                         device=self.device)
            for k, v in {**{f"{k}_mismatches": v for k, v in envs.items()},
                         **out}.items():
                counts[k] = counts.get(k, 0) + v
            for k, v in got.items():
                readings[k] = max(readings.get(k, v), v)
        compared = dict(generations=len(self.recs), envs=self.batch,
                        env_steps=len(self.recs) * self.steps_per_call,
                        members=self.pop, parameters=int(
                            self.recs[0]["theta"].numel()),
                        q_pair=self.pair, **readings)
        return common.checks(counts), compared


def _fitness(rewards: np.ndarray, k_env: int) -> np.ndarray:
    """The reference's fitness [pop] of the replayed rewards [T, envs]:
    the rewards of this configuration are whole numbers, so their float32
    sums in any order are exact and the fitness is compared exactly."""
    import torch
    from ..reference_torch import es as R
    return R.fitness(torch.from_numpy(rewards), k_env).float().numpy()


def record_generation(es, gen, state, pair: int, sigma: float,
                      host: bool = False) -> dict:
    """``gen(state)`` with hooks that record what it computes and change
    none of it: the first frames, every step's actions, frames, rewards and
    dones (frames as uint8 on the host), the perturbations, fitness and
    outputs of the update, and the new state (``state``). Then the
    Q-values of the members ``pair`` and ``pair + pop / 2`` at every step:
    the trainer's own ``member_forward`` of the whole population, rebuilt
    from theta and the recorded eps as ``gen`` builds it, on the recorded
    frames, which is the generation's forward on the same inputs. ``host``:
    every tensor of the record on the host, the state's left on its
    device."""
    import torch
    rec = dict(theta=state.theta.clone(), key=state.key.cpu(), actions=[],
               obs=[], rewards=[], dones=[], obs_not_u8=0)
    real = {n: getattr(es, n) for n in ("reset_fn", "step_fn", "es_update")}

    def frames(obs):
        """The frames as uint8 on the host; a pixel that is not a whole
        number in [0, 255] counts as differing."""
        as_u8 = obs.to(torch.uint8)
        rec["obs_not_u8"] += int((as_u8.float() != obs).sum())
        return as_u8.cpu().numpy()

    def reset_fn(*args, **kw):
        obs, st = real["reset_fn"](*args, **kw)
        rec["obs"].append(frames(obs))
        return obs, st

    def step_fn(cfg, st, action, *args):
        out = real["step_fn"](cfg, st, action, *args)
        rec["actions"].append(action.cpu().numpy())
        rec["obs"].append(frames(out[0]))
        rec["rewards"].append(out[2].cpu().numpy())
        rec["dones"].append(out[3].cpu().numpy())
        return out

    def es_update(theta, eps, fitness, **kw):
        out = real["es_update"](theta, eps, fitness, **kw)
        rec["eps"], rec["fitness"] = eps, fitness.cpu().numpy()
        rec["theta_after"], rec["grad"] = out
        return out

    hooks = dict(reset_fn=reset_fn, step_fn=step_fn, es_update=es_update)
    for name, fn in hooks.items():
        setattr(es, name, fn)
    try:
        rec["state"], _ = gen(state)
    finally:
        for name, fn in real.items():
            setattr(es, name, fn)
    for k in ("actions", "obs", "rewards", "dones"):
        rec[k] = np.stack(rec[k])
    T, n = rec["actions"].shape
    pop = rec["eps"].shape[0]
    k = n // pop
    dev = rec["theta"].device
    two = torch.tensor([pair, pair + pop // 2], device=dev)
    members = gen.unravel(es.threefry._fma(rec["eps"], sigma,
                                           rec["theta"][None]))
    with torch.no_grad():
        rec["q"] = torch.stack([gen.member_forward(members, torch.from_numpy(
            o).to(dev).float().reshape((pop, k) + o.shape[1:]))
            .index_select(0, two) for o in rec["obs"][:T]], 1)  # [2, T, k, A]
    del members
    # the pair's frames at each step's forward: the reset's, then each
    # step's but the last
    envs = np.concatenate([np.arange(pair * k, pair * k + k),
                           np.arange((pair + pop // 2) * k,
                                     (pair + pop // 2 + 1) * k)])
    rec["q_obs"] = torch.from_numpy(
        rec["obs"][:T, envs].reshape((T, 2, k) + rec["obs"].shape[2:])
        .transpose(1, 0, 2, 3, 4).copy()).to(dev).float()
    from ..reference_torch import es as R
    rec["keys"] = R.keys(rec["key"])
    rec["pair"] = pair
    if host:
        for k in ("theta", "eps", "q", "q_obs", "theta_after", "grad"):
            rec[k] = rec[k].cpu()
    return rec


def replay_envs(config: dict, key, actions: np.ndarray, obs: np.ndarray,
                rewards: np.ndarray, dones: np.ndarray, device="cpu") -> dict:
    """The reference's replay of every env from the generation's reset key
    on the program's ``actions`` [T, envs], against its frames ``obs``
    (uint8 [T + 1, envs, 84, 84], the reset's first), ``rewards`` and
    ``dones`` [T, envs]: the counts of differing pixels, rewards and dones,
    and the reference's rewards. The reset splits the key once, each step
    twice (the spawn draw, the auto-reset's draw for the games that died).
    The frames are compared on ``device`` (``_Raster``)."""
    T, n = actions.shape
    envs = np.arange(n)
    g = Games(config, n)
    key, draw = threefry.split(key)
    g.clear(np.ones(n, bool), threefry.bits([draw], envs)[0])
    image = _Raster(g.W, g.H, device)
    out = dict(pixel=image.mismatches(g.board, obs[0]), reward=0, done=0,
               rewards=np.zeros((T, n), np.float32))
    for t in range(T):
        key, spawn = threefry.split(key)
        key, again = threefry.split(key)
        emitted, out["rewards"][t], done = g.step(
            actions[t], threefry.bits([spawn], envs)[0])
        g.clear(done, threefry.bits([again], envs)[0])
        emitted[done] = 0
        out["pixel"] += image.mismatches(emitted, obs[t + 1])
        out["reward"] += common.mismatches(rewards[t], out["rewards"][t])
        out["done"] += common.mismatches(dones[t], done)
    return out


def _ulps(a, b):
    """The distance of float32 tensors in units in the last place (the
    count of float32 values between them)."""
    import torch
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i >= 0, i, -(i & 0x7FFFFFFF))
    return (ordered(a) - ordered(b)).abs()


BLOCK = 1 << 17     # columns of eps the reference draws at a time


def generation_checks(rec: dict, cfg, agent: dict, control: bool = False,
                      negate: bool = True, device=None):
    """The plain reference's eps, Q-values and update against the
    program's recorded generation, on ``device`` (the recording's by
    default): (readings, the counts outside ``TOL``). The readings are
    each quantity's largest error in the units of its tolerance.
    ``control``: the reference computed below the configuration's
    precision in the program's place (its eps rounded to bf16, its update
    on that eps, its Q-values through float8). ``negate=False``: the
    reference's antithetic half left un-negated."""
    import torch
    from ..reference_torch import es as R
    eps = rec["eps"]
    dev = rec["theta"].device if device is None else torch.device(device)
    theta = rec["theta"].to(dev)
    dim, pop = theta.numel(), eps.shape[0]
    half, k_eps = pop // 2, rec["keys"][0]
    lr, wd, sigma = cfg.lr, cfg.weight_decay, cfg.sigma
    shaped = R.centered_ranks(torch.from_numpy(rec["fitness"]).to(dev))
    u = 2.0 ** -24
    gamma = (pop + 8) * u / (1 - (pop + 8) * u)
    worst, out = {}, dict(eps_out_of_tol=0, grad_out_of_tol=0,
                          theta_out_of_tol=0)
    top = lambda k, v: worst.__setitem__(k, max(worst.get(k, 0.0), float(v)))
    for c0 in range(0, dim, BLOCK):
        c1 = min(dim, c0 + BLOCK)
        full = R.antithetic(R.normal(k_eps, (0, half), (c0, c1), dim, dev),
                            negate)
        th = theta[c0:c1]
        g = R.gradient(shaped, full, sigma)
        if control:
            low = full.bfloat16().float()
            got_eps, got_g = low, R.gradient(shaped, low, sigma)
            got_th = R.step(th, got_g, lr, wd)
        else:
            got_eps, got_g = eps[:, c0:c1].to(dev), rec["grad"][c0:c1].to(dev)
            got_th = rec["theta_after"][c0:c1].to(dev)
        d = _ulps(got_eps, full)
        out["eps_out_of_tol"] += int((d > TOL["eps_ulps"]).sum())
        top("eps_max_ulps", d.max())
        # the bound on g: gamma of the sum of |terms| for the program's
        # order and again for the reference's (n + 8: eps's 4 ulp), 3 u of
        # sum |eps| (a rank's rounding), 6 u of |g| (1 / (pop sigma)); on
        # theta': lr times g's, and 12 u of each term's size (lr, 1 - lr
        # wd, their products and the sum)
        terms = R.gradient(shaped.abs(), full.abs(), sigma)
        ranks = R.gradient(torch.full_like(shaped, 3 * u), full.abs(), sigma)
        bound = (2 * gamma * terms + ranks + 6 * u * g.abs()).clamp(min=1e-37)
        t_bound = lr * bound + 12 * u * ((1 - lr * wd) * th.abs()
                                         + lr * g.abs())
        eg = (got_g - g).abs() / bound
        et = (got_th - R.step(th, g, lr, wd)).abs() / t_bound.clamp(min=1e-37)
        top("grad_err", eg.max())
        top("theta_err", et.max())
        out["grad_out_of_tol"] += int((eg > TOL["update"]).sum())
        out["theta_out_of_tol"] += int((et > TOL["update"]).sum())
    # the pair's Q-values
    lay = R.layout(agent["frame_size"], 1, agent["convs"], agent["dense"],
                   agent["num_actions"])
    i = rec["pair"]
    row = R.normal(k_eps, (i, i + 1), (0, dim), dim, dev)[0]
    out["q_out_of_tol"] = 0
    for m in (0, 1):
        obs = rec["q_obs"][m].reshape((-1,) + rec["q_obs"].shape[-2:]).to(
            dev)
        sound = 1.0 if m == 0 else -1.0
        sign = sound if negate else 1.0
        q = lambda s, **kw: R.member_q_values(theta, row, sigma, s, obs, lay,
                                              **kw)
        want, plain = q(sign), q(sound)
        scale = yardstick(plain, q(sound, dtype=torch.bfloat16))
        got = (q(sound, act_round=torch.float8_e4m3fn) if control
               else rec["q"][m].reshape(want.shape).to(dev))
        err = (got - want).abs() / scale
        out["q_out_of_tol"] += int((err > TOL["q"]).sum())
        top("q_err", err.max())
    return worst, out


def yardstick(plain, bf16):
    """How far the reference's Q-values move when computed in bf16: the
    largest error, at least one bf16 step (2**-8) of the largest
    Q-value."""
    return (bf16 - plain).abs().max().clamp(min=2.0 ** -8
                                            * plain.abs().max())


def _check_network(net, theta, agent: dict) -> None:
    """The trainer's policy has the configuration's widths, parameter count
    and compute dtype, and theta its parameter dtype."""
    import torch
    want = {f"conv{i + 1}.weight": (c, None, k, k)
            for i, (c, k, _) in enumerate(agent["convs"])}
    want["dense.weight"] = (agent["dense"], None)
    want["q.weight"] = (agent["num_actions"], agent["dense"])
    params = net.state_dict()
    for name, shape in want.items():
        got = tuple(params[name].shape)
        if len(got) != len(shape) or any(s is not None and s != g
                                         for s, g in zip(shape, got)):
            raise ValueError(f"{name}: {got}, the configuration says {shape}")
    if net.dtype != getattr(torch, agent["compute_dtype"]):
        raise ValueError(f"compute dtype {net.dtype}")
    if theta.dtype != getattr(torch, agent["param_dtype"]):
        raise ValueError(f"theta is {theta.dtype}")
    if theta.numel() != agent["parameters"]:
        raise ValueError(f"{theta.numel()} parameters, the configuration "
                         f"says {agent['parameters']}")


class _Raster:
    """``raster.image`` of 0 / 1 boards [n, W, H] (``raster.grayscale``'s
    transpose) as uint8 on a torch device: each pixel is its base shade
    plus the shade of a filled block where the cell it shows is filled, one
    gather of the cells into the reference's pixel map."""

    def __init__(self, width: int, height: int, device):
        import torch
        base, cell = raster._maps(height, width, 84)
        self.cells, self.device = width * height, device
        self.base = torch.from_numpy(base.astype(np.uint8).reshape(-1)).to(
            device)
        self.idx = torch.from_numpy(np.where(cell < 0, self.cells, cell)
                                    .reshape(-1)).to(device)

    def mismatches(self, boards: np.ndarray, frames: np.ndarray) -> int:
        """The pixels of the program's ``frames`` (uint8 [n, 84, 84]) that
        differ from the images of ``boards``."""
        import torch
        n = boards.shape[0]
        cells = np.zeros((n, self.cells + 1), np.uint8)
        cells[:, :self.cells] = np.swapaxes(boards, 1, 2).reshape(n, -1)
        cells = torch.from_numpy(cells).to(self.device)
        shade = raster.PIECE - raster.BACKGROUND
        want = self.base + shade * cells[:, self.idx]
        got = torch.from_numpy(frames).to(self.device).reshape(n, -1)
        return int((got != want).sum())
