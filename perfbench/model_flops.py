"""The model FLOPs of the flagship Rainbow agent (``rainbow_flagship``), from
the widths in its configuration's ``agent``: convolutions and matrix
products only, two FLOPs a multiply-add. Elementwise work (the noisy
weights' outer products, the dueling mean, softmaxes, the projection, PER's
sums, Adam) counts 0.

A forward of one sample at 84 px, a stack of 4, convs 32x8/4, 64x4/2,
64x3/1, dense 512, a dueling C51 head of 7 actions x 51 atoms: 9,551,872
multiply-adds (conv 3,276,800 + 2,654,208 + 1,806,336, dense 1,605,632,
value 26,112, advantage 182,784).

- An actor step: one forward of every env's stack.
- A learner update (``train/dqn.py`` ``c51_loss``): the online forward on
  s, the target's on s', the online one on s' for the double-DQN choice,
  and the backward of the first, which takes the weights' gradients of
  every layer and the input's of every layer but the first conv (the frames
  need none): 3 forwards + 2 forwards - the first conv a row.
"""

from __future__ import annotations

# one H100 SXM's dense BF16 peak (NVIDIA's data sheet)
H100_BF16_FLOPS = 989.4e12


def at_batch(agent: dict, batch: int) -> dict:
    """The agent at ``batch`` envs with its per-env sizes kept (ring slots,
    learner rows and warm-up slots per env): the cell's own agent where
    ``batch`` is its ``num_envs``, a smaller one for CPU runs."""
    envs = agent["num_envs"]
    if batch == envs:
        return agent
    per_env = {k: agent[k] // envs for k in ("buffer_capacity", "learn_batch",
                                             "learn_starts")}
    return dict(agent, num_envs=batch,
                **{k: v * batch for k, v in per_env.items()})


def layer_macs(agent: dict) -> list:
    """(name, multiply-adds of one sample) of each conv and dense layer."""
    w = agent["width_mult"]
    side, cin = agent["frame_size"], agent["frame_stack"]
    out = []
    for i, (cout, k, s) in enumerate(agent["convs"]):
        side = (side - k) // s + 1
        out.append((f"conv{i + 1}", side * side * cout * w * k * k * cin))
        cin = cout * w
    dense = agent["dense"] * w
    out.append(("dense", side * side * cin * dense))
    a, z = agent["num_actions"], agent["num_atoms"]
    out += [("value", dense * z), ("advantage", dense * a * z)]
    return out


def forward_macs(agent: dict) -> int:
    return sum(m for _, m in layer_macs(agent))


def actor_step_flops(agent: dict) -> int:
    return 2 * agent["num_envs"] * forward_macs(agent)


def learner_update_flops(agent: dict) -> int:
    fwd = forward_macs(agent)
    first = layer_macs(agent)[0][1]
    return 2 * agent["learn_batch"] * (3 * fwd + 2 * fwd - first)


def bf16_peak_share(flops: float, seconds: float) -> float:
    """Percent of the card's dense BF16 peak that ``flops`` in ``seconds``
    reach."""
    return 100.0 * flops / (seconds * H100_BF16_FLOPS)
