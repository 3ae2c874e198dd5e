"""The operations and bytes of the ES policy (``es_gray``), from the widths
in its configuration's ``agent``: frozen here so that the yardstick does
not move with the program.

A forward of one 84 x 84 frame through the Nature-DQN policy of one input
channel (conv 32x8/4, 64x4/2, 64x3/1, dense 512, 7 Q-values): 6,888,960
multiply-adds (conv 819,200 + 2,654,208 + 1,806,336, dense 1,605,632, q
3,584), two FLOPs each; elementwise work counts 0. Its parameters:
1,681,575 float32.

A step of the population's forward (``train/es.py``, each step's
``member_forward``) must read every member's parameters once, in the
configuration's compute dtype (``compute_dtype`` bfloat16: 2 B each; the
float32 parameters need be read and cast only once a generation, 1 / 256
of a step's read at horizon 256, which is not counted), and every env's
frame once as the forward reads it (float32): ``members x parameters x 2 +
envs x 84 x 84 x 4`` bytes, 1.78 GB at 512 x 4 envs, 0.53 ms at 3.35 TB/s.
"""

from __future__ import annotations

import math

# one H100 SXM's dense BF16 peak and HBM3 rate (NVIDIA's data sheet)
H100_BF16_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12


def layer_shapes(agent: dict) -> list:
    """(name, multiply-adds of one frame, parameters) of each layer."""
    side, cin = agent["frame_size"], 1
    out = []
    for i, (cout, k, s) in enumerate(agent["convs"]):
        side = (side - k) // s + 1
        out.append((f"conv{i + 1}", side * side * cout * k * k * cin,
                    cout * k * k * cin + cout))
        cin = cout
    flat, dense, a = side * side * cin, agent["dense"], agent["num_actions"]
    out += [("dense", flat * dense, flat * dense + dense),
            ("q", dense * a, dense * a + a)]
    return out


def forward_macs(agent: dict) -> int:
    return sum(m for _, m, _ in layer_shapes(agent))


def parameters(agent: dict) -> int:
    return sum(p for _, _, p in layer_shapes(agent))


def step_flops(agent: dict, envs: int) -> int:
    """FLOPs of one step's forward of every env's frame."""
    return 2 * envs * forward_macs(agent)


# bytes of an element of each compute dtype
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def step_bytes(agent: dict, envs: int) -> int:
    """Bytes one step's population forward must move: the members'
    parameters in the compute dtype and the envs' float32 frames."""
    members = envs // agent["envs_per_member"]
    return (DTYPE_BYTES[agent["compute_dtype"]] * members * parameters(agent)
            + 4 * envs * math.prod((agent["frame_size"],) * 2))
