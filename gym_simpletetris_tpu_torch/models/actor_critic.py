"""Actor-critic networks for PPO (port of
``gym_simpletetris_tpu.models.actor_critic``): float32 parameters, compute in
``dtype`` (bfloat16 by default), float32 logits and value.

Each layer rounds where jitted flax does on XLA. A Dense or Conv layer takes
the product of ``dtype``-rounded operands, sums it in float32 and rounds it
once to ``dtype`` (what XLA's CPU backend runs for a bf16 dot, and what a
bf16 GEMM with float32 accumulation computes), then adds the bias in
``dtype`` as a second op: ``F.linear`` / ``addmm`` add the bias before they
round, which moves about half the bf16 logits by an ulp and flips greedy
actions. The logits head keeps its bias sum in float32, as XLA does for
``pi(z).astype(float32)`` under jit. With torch's own bf16 matmul the float32
sum runs in another order; the greedy line-clear agent then takes another
action about once in 10^5 decisions. The conv trunk takes NHWC input like
the flax one, runs ``F.conv2d`` in NCHW, and flattens in NHWC order, so the
``fc`` weight is the plain transpose of the flax kernel. A float32 network
convolves in float32 on the card too, not in cuDNN's default TF32.

The cast of a parameter to ``dtype`` rounds its gradient to ``dtype`` on
the way back, as flax's does; each use of a weight or bias is one such
cast point. A data-parallel learner sums the gradients of its ranks'
shares of a batch: under ``cast_points()`` every cast point of a forward
passes its float32 gradient through unrounded and is recorded, so that the
learner can sum the shares first and round once, as the unsharded
gradient is rounded (``train.sharding.DataParallel.grads``).

Tensor parallelism over a model axis of n ranks (``shard_layers``): a
Dense, Conv or NoisyDense layer whose output width divides by n holds its
block of output rows (dim 0 of its weight) and the whole bias. It computes
its block of the output, ``(x_bf16.float() @ W_r^T).to(dtype)``, all-gathers
the blocks along the feature axis (the last, or dim 1 of an NCHW conv
output) and adds the whole bias: every output element is the unsharded
layer's dot product, so the forward is the unsharded one's. On the way back
the gather gives each rank its block's gradient, and the identity on the
layer's float32 input sums the ranks' partial input gradients over the
model group (Megatron's "g" and "f"). That sum runs in float32, before the
``.float()`` cast rounds it once to ``dtype``: summing the partials after
each rank had rounded them would not be the unsharded rounding.

``params_from_flax`` carries a flax parameter tree across. Fresh parameters
follow flax's default initialisers (LeCun-normal truncated kernels, zero
biases), drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
import torch.nn.functional as F

from ..core.engine import NUM_ACTIONS

# flax's truncated-normal correction: the std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


# the cast points recorded by ``cast_points``: (point, dtype of the cast)
_POINTS: Optional[list] = None


@contextlib.contextmanager
def cast_points():
    """Within the block, each cast of a parameter (or a tensor made from
    parameters, as a NoisyDense's noisy weight) that autograd records keeps
    its float32 gradient unrounded; yields the list of (point, dtype) it
    fills: ``grad(loss, point)`` is that float32 gradient, and rounding it
    to ``dtype`` gives what the block's absence would have given."""
    global _POINTS
    saved, _POINTS = _POINTS, []
    try:
        yield _POINTS
    finally:
        _POINTS = saved


def _recording(p: torch.Tensor) -> bool:
    return _POINTS is not None and torch.is_grad_enabled() and p.requires_grad


class _CastThrough(torch.autograd.Function):
    """``p.to(dtype).float()`` whose backward passes the float32 gradient
    through unrounded."""

    @staticmethod
    def forward(ctx, p, dtype):
        return p.to(dtype=dtype, copy=True).float()

    @staticmethod
    def backward(ctx, g):
        return g, None


class _BiasAddThrough(torch.autograd.Function):
    """``y + b.to(y.dtype).reshape(shape)`` whose bias gradient is the
    float32 sum over the broadcast axes, unrounded."""

    @staticmethod
    def forward(ctx, y, b, shape):
        b = b.to(y.dtype).reshape(shape)
        ctx.shape = b.shape
        return y + b

    @staticmethod
    def backward(ctx, g):
        return g, g.float().sum_to_size(ctx.shape).reshape(-1), None


def cast(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A parameter as a layer computes with it: ``p.to(dtype).float()``;
    a cast point under ``cast_points``."""
    if not _recording(p):
        return p.to(dtype).float()
    out = _CastThrough.apply(p, dtype)
    _POINTS.append((out, dtype))
    return out


def add_bias(y: torch.Tensor, b: torch.Tensor, shape=(-1,)) -> torch.Tensor:
    """``y + b.to(y.dtype)``, ``b`` viewed as ``shape`` (its axis broadcast
    against ``y``'s); a cast point under ``cast_points``."""
    if not _recording(b):
        return y + b.to(y.dtype).reshape(shape)
    point = b.view_as(b)            # this use's own tensor
    _POINTS.append((point, y.dtype))
    return _BiasAddThrough.apply(y, point, shape)


class ModelShard(NamedTuple):
    """A layer's place on the model axis: the axis's process group, this
    rank's index on it and the axis's size."""
    group: object
    rank: int
    n: int


def _layout(t: torch.Tensor) -> torch.memory_format:
    """The memory format a collective's result must keep: a conv's NCHW
    activations are channels-last in memory (the trunk permutes NHWC
    frames), and the next conv picks its algorithm, and with it its order
    of summation, by that layout."""
    if t.dim() == 4 and not t.is_contiguous() and \
            t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


class _ToModel(torch.autograd.Function):
    """The identity; its backward sums the model ranks' partial gradients
    (one ``all_reduce`` over the group)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        layout = _layout(g)
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g.contiguous(memory_format=layout), None


class _FromModel(torch.autograd.Function):
    """The model ranks' output blocks concatenated along ``dim`` (one
    ``all_gather``), in the block's memory layout; its backward takes this
    rank's block."""

    @staticmethod
    def forward(ctx, y, shard, dim):
        ctx.rank, ctx.dim, ctx.size = shard.rank, dim, y.shape[dim]
        layout = _layout(y)
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(shard.n)]
        dist.all_gather(parts, y, group=shard.group)
        return torch.cat(parts, dim).contiguous(memory_format=layout)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           dtype: torch.dtype, round_sum: bool = True,
           shard: Optional[ModelShard] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` as jitted flax computes it in ``dtype``: the
    product of rounded operands summed in float32 and rounded once, then the
    bias added in ``dtype``; ``round_sum=False`` adds the bias in float32
    and returns float32. With ``shard``, ``weight`` is this rank's block of
    output rows and the blocks of the product are gathered (module
    docstring)."""
    xf = x.to(dtype).float()
    if shard is not None:
        xf = _ToModel.apply(xf, shard.group)
    y = (xf @ cast(weight, dtype).T).to(dtype)
    if shard is not None:
        y = _FromModel.apply(y, shard, -1)
    if round_sum:
        return add_bias(y, bias)
    return y.float() + cast(bias, dtype)


class Layer(nn.Module):
    """A layer that ``shard_layers`` may split over a model axis:
    ``features`` is its whole output width, ``shard`` its ``ModelShard``
    while it holds a block of its output rows (else None)."""
    shard: Optional[ModelShard] = None

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.features = features
        self.dtype = dtype


def shard_layers(network: nn.Module, shard: Optional[ModelShard]) -> int:
    """Split every layer of ``network`` whose output width divides by the
    model axis's size over it (module docstring), as the placements of
    ``train.sharding`` split its weights; the rest stay whole. ``None``
    makes every layer whole. Returns the count of split layers."""
    count = 0
    for m in network.modules():
        if isinstance(m, Layer):
            split = shard is not None and m.features % shard.n == 0
            m.shard = shard if split else None
            count += split
    return count


class Dense(Layer):
    """flax ``nn.Dense``: weight [out, in] (the flax kernel transposed)."""

    def __init__(self, features_in: int, features: int, dtype: torch.dtype):
        super().__init__(features, dtype)
        self.weight = nn.Parameter(torch.zeros(features, features_in))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        _lecun_normal_(self.weight, self.weight.shape[1], gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, round_sum: bool = True) -> torch.Tensor:
        """``round_sum=False`` adds the bias in float32 and returns float32."""
        return linear(x, self.weight, self.bias, self.dtype, round_sum,
                      self.shard)


@contextlib.contextmanager
def _ieee_conv():
    """cuDNN convolutions in full float32 precision for the block."""
    conv = torch.backends.cudnn.conv
    saved = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = saved


class Conv(Layer):
    """flax ``nn.Conv`` with VALID padding on NCHW activations: weight OIHW
    (the flax HWIO kernel permuted)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 dtype: torch.dtype):
        super().__init__(cout, dtype)
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, gen: torch.Generator) -> None:
        _lecun_normal_(self.weight, self.weight[0].numel(), gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x, w = x.to(dt).float(), cast(self.weight, dt)
        if self.shard is not None:
            x = _ToModel.apply(x, self.shard.group)
        # cuDNN convolves float32 in TF32 unless told not to; bf16-valued
        # operands are exact in TF32 and keep it
        exact = _ieee_conv() if dt == torch.float32 else contextlib.nullcontext()
        with exact:
            y = F.conv2d(x, w, stride=self.stride).to(dt)
        if self.shard is not None:
            y = _FromModel.apply(y, self.shard, 1)
        return add_bias(y, self.bias, (-1, 1, 1))


class ConvTrunk(nn.Module):
    """Three VALID convs (32x8/4, 64x4/2, 64x3/1) on an 84 x 84 image."""

    def __init__(self, in_channels: int = 1, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(in_channels, 32, 8, 4, dtype)
        self.conv2 = Conv(32, 64, 4, 2, dtype)
        self.conv3 = Conv(64, 64, 3, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]
        x = (x.to(self.dtype) / 255.0).permute(0, 3, 1, 2)   # NHWC -> NCHW
        for conv in (self.conv1, self.conv2, self.conv3):
            x = F.relu(conv(x))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten


class MlpTrunk(nn.Module):
    def __init__(self, features_in: int, hidden: Sequence[int] = (512, 256),
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        sizes = (features_in,) + tuple(hidden)
        for i in range(len(hidden)):
            self.add_module(f"dense{i}", Dense(sizes[i], sizes[i + 1], dtype))
        self.hidden = tuple(hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(len(self.hidden)):
            x = F.relu(getattr(self, f"dense{i}")(x))
        return x


class ActorCritic(nn.Module):
    """Shared trunk, separate policy-logits and value heads.

    ``obs_shape`` is the per-env observation shape; ``obs_type`` picks the
    trunk: conv for 84 x 84 images, MLP for ram boards. Returns
    (logits float32[B, A], value float32[B]).
    """

    def __init__(self, obs_shape: Tuple[int, ...], obs_type: str = "ram",
                 num_actions: int = NUM_ACTIONS, dtype=torch.bfloat16):
        super().__init__()
        self.obs_type = obs_type
        self.dtype = dtype
        if obs_type == "ram":
            self.trunk = MlpTrunk(int(np.prod(obs_shape)), dtype=dtype)
            z = self.trunk.hidden[-1]
        else:
            cin = obs_shape[-1] if len(obs_shape) == 3 else 1
            self.trunk = ConvTrunk(cin, dtype=dtype)
            side = obs_shape[0]
            for k, s in ((8, 4), (4, 2), (3, 1)):
                side = (side - k) // s + 1
            self.fc = Dense(side * side * 64, 512, dtype)
            z = 512
        self.pi = Dense(z, num_actions, dtype)
        self.v = Dense(z, 1, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, Layer):
                m.reset_parameters(gen)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.trunk(x)
        if self.obs_type != "ram":
            z = F.relu(self.fc(z))
        # flax's ``pi(z).astype(float32)``: XLA keeps the bias sum in float32
        # (excess precision, on by default) and rounds only the product
        logits = self.pi(z, round_sum=False)
        value = self.v(z)[:, 0]
        return logits, value.float()


# flax leaf name -> (port name, is a kernel)
_FLAX_LEAVES = {"kernel": ("weight", True), "bias": ("bias", False),
                "kernel_mu": ("weight_mu", True), "bias_mu": ("bias_mu", False),
                "kernel_sigma": ("weight_sigma", True),
                "bias_sigma": ("bias_sigma", False)}


def params_from_flax(tree) -> dict:
    """A flax ActorCritic or Q-network parameter tree (nested dicts of
    numpy arrays, with or without the outer ``"params"`` key) -> a
    state_dict of float32 CPU tensors for ``ActorCritic`` or
    ``models.dqn``'s networks. A Dense kernel [in, out] becomes a weight
    [out, in], a Conv kernel HWIO an OIHW weight, a NoisyDense's
    ``kernel_mu`` / ``kernel_sigma`` the weights ``weight_mu`` /
    ``weight_sigma`` likewise; the flax trunk module (``MlpTrunk_0`` /
    ``ConvTrunk_0``) is ``trunk``."""
    if "params" in tree:
        tree = tree["params"]
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        a = np.asarray(node, dtype=np.float32)
        mods = ["trunk" if p in ("MlpTrunk_0", "ConvTrunk_0") else p
                for p in path[:-1]]
        if path[-1] not in _FLAX_LEAVES:
            raise ValueError(f"unexpected flax parameter {'/'.join(path)}")
        name, kernel = _FLAX_LEAVES[path[-1]]
        if kernel:
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        out[".".join(mods + [name])] = torch.tensor(a)    # a copy

    walk(tree, ())
    return out
