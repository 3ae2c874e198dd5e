"""Q-networks for the DQN trainer (port of
``gym_simpletetris_tpu.models.dqn``): float32 parameters, compute in
``dtype`` (bfloat16 by default), float32 Q-values [B, A] or C51 logits
[B, A, num_atoms].

- ``NatureDQN``: the Atari conv trunk (32x8/4, 64x4/2, 64x3/1 times
  ``width_mult``, dense 512 * width_mult) on NHWC 84 x 84 frames, the
  stacked frames on the channel axis;
- ``RamDQN``: an MLP (512, 256) on the (W, H) ram board;
- ``DuelingHead``: V + A - mean_a A; ``C51Head``: categorical logits,
  dueling per atom;
- ``NoisyDense``: the factorised-Gaussian noisy linear layer. ``noisy=True``
  swaps every fully connected layer for it (the convs stay plain). On the
  card its noisy weights are one launch of the noise kernel
  (``ops/cuda_noise.py``), bitwise the plain version, which CPU
  parameters take.

Each network's ``forward(x, noise_key=None)`` takes the noise key
explicitly, as a threefry key: ``noise_key`` is the key flax's
``apply(..., rngs={"noise": noise_key})`` is given, and each NoisyDense
derives its own key from it as flax's ``make_rng("noise")`` does
(``threefry.flax_rng`` over the module path), so the noise is
``jax.random``'s bit for bit. Without a key a noisy network is the
deterministic mu-only network (the evaluation policy).

Rounding follows jitted flax as XLA's CPU backend fuses it (read from its
optimised HLO): a layer that feeds a relu rounds its bias sum to ``dtype``;
a plain output head keeps its bias sum in float32 (XLA's excess precision),
a noisy C51 head rounds it; the dueling combination is ``_dueling``. The
noisy weights ``mu + sigma * noise`` are one fused multiply-add in float32,
as XLA contracts them. On boards from play the bf16 forwards are bitwise;
on random dense boards an element sits an ulp away now and then, where the
float32 sum of a product rounds the other way in torch's order. The matmuls and convolutions are plain
``torch`` ops (cuBLAS / cuDNN on the card), as the JAX package computes
them outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..core import threefry
from ..core.engine import NUM_ACTIONS
from ..ops import cuda_noise
from ..utils.profiling import count, span
from .actor_critic import Conv, Dense, Layer, linear


def _signed_sqrt(e: torch.Tensor) -> torch.Tensor:
    """The factorised noise's ``f(e) = sign(e) sqrt(|e|)``."""
    return torch.sign(e) * threefry.sqrt_f32(e.abs())


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (the product is exact in float64);
    differentiable in a and c."""
    return (a.double() * b.double() + c.double()).float()


class NoisyDense(Layer):
    """Factorised-Gaussian noisy linear layer (Fortunato et al. 2018):
    ``y = (W_mu + W_sigma * f(eps_out) f(eps_in)^T) x + b_mu + b_sigma *
    f(eps_out)``. Weights are [out, in] (the flax kernels transposed);
    ``path`` is the module's flax path, which its noise key folds in. Split
    over a model axis it holds its block of the weights' rows and draws the
    whole ``eps_out``, of which it takes its block: its noisy weight is
    those rows of the unsharded layer's, bit for bit."""

    def __init__(self, features_in: int, features: int, dtype: torch.dtype,
                 path: Tuple[str, ...], sigma0: float = 0.5):
        super().__init__(features, dtype)
        self.path = tuple(path)
        # flax_rng's fold_in data for this layer's noise key, hashed once
        self.fold = threefry.flax_fold(*self.path, 1)
        self.sigma0 = sigma0
        self.weight_mu = nn.Parameter(torch.zeros(features, features_in))
        self.bias_mu = nn.Parameter(torch.zeros(features))
        self.weight_sigma = nn.Parameter(torch.zeros(features, features_in))
        self.bias_sigma = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax's init: mu ~ U[-1/sqrt(in), 1/sqrt(in)), sigma =
        sigma0 / sqrt(in)."""
        fin = self.weight_mu.shape[1]
        bound = 1.0 / math.sqrt(fin)
        with torch.no_grad():
            for p in (self.weight_mu, self.bias_mu):
                p.uniform_(0.0, 2 * bound, generator=gen).sub_(bound)
            for p in (self.weight_sigma, self.bias_sigma):
                p.fill_(self.sigma0 / math.sqrt(fin))

    @span("model.noise")
    def noisy_weights(self, noise_key: torch.Tensor):
        """(weight, bias) under the noise drawn from ``noise_key`` (the key
        the whole network was given): one launch of the noise kernel
        (``ops/cuda_noise.py``) for CUDA parameters, the plain version for
        the rest."""
        count("model.noise_draws")
        if not self.weight_mu.is_cuda:
            return self.noisy_weights_plain(noise_key)
        at = self.shard.rank * self.weight_mu.shape[0] \
            if self.shard is not None else 0
        return cuda_noise.noisy_weights(
            noise_key, self.fold, self.weight_mu, self.weight_sigma,
            self.bias_mu, self.bias_sigma, at)

    def noisy_weights_plain(self, noise_key: torch.Tensor):
        """``noisy_weights`` in plain torch on the threefry of
        ``core/threefry.py``: the noise kernel's oracle."""
        rows, in_f = self.weight_mu.shape
        at = self.shard.rank * rows if self.shard is not None else 0
        ki, ko = threefry.split(threefry.flax_rng(noise_key, *self.path, 1))
        e_in = _signed_sqrt(threefry.normal(ki, (in_f, 1)))
        e_out = _signed_sqrt(threefry.normal(ko, (1, self.features)))
        e_rows = e_out[:, at:at + rows]
        w = _fma_f32(self.weight_sigma, (e_in * e_rows).T, self.weight_mu)
        b = _fma_f32(self.bias_sigma, e_out[0], self.bias_mu)
        return w, b

    def forward(self, x: torch.Tensor, noise_key: Optional[torch.Tensor] = None,
                round_sum: bool = True) -> torch.Tensor:
        if noise_key is None:
            w, b = self.weight_mu, self.bias_mu
        else:
            w, b = self.noisy_weights(noise_key)
        return linear(x, w, b, self.dtype, round_sum, self.shard)


def _dense(noisy: bool, fin: int, fout: int, dtype, path: Tuple[str, ...]):
    """The value pathway's linear layer: noisy or plain."""
    if noisy:
        return NoisyDense(fin, fout, dtype, path)
    return Dense(fin, fout, dtype)


def _apply(layer, x, noise_key, round_sum=True):
    if isinstance(layer, NoisyDense):
        return layer(x, noise_key, round_sum)
    return layer(x, round_sum)


def _dueling(value, advantage, x, noise_key, atoms_shape):
    """V + A - mean_a A as XLA fuses it for jitted flax: V and A rounded to
    ``dtype`` and their sum rounded; the mean summed in float32 in index
    order over A's bias sums (a reduce of fewer than 33 elements), times
    the float32 reciprocal of the action count, then rounded; the
    difference kept in float32. ``atoms_shape`` (A, Z) makes it per atom
    (C51), the mean over the action axis."""
    dt = advantage.dtype
    v = _apply(value, x, noise_key)
    # a noisy C51 advantage's bias sum is rounded too (a fusion of its own)
    a_sum = _apply(advantage, x, noise_key,
                   round_sum=atoms_shape is not None
                   and isinstance(advantage, NoisyDense))
    if atoms_shape is not None:
        a_sum = a_sum.reshape(a_sum.shape[:-1] + atoms_shape)
        v, axis = v[..., None, :], -2
    else:
        axis = -1
    parts = a_sum.float().unbind(axis)
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    inv = float(torch.tensor(1.0 / len(parts), dtype=torch.float32))
    mean = (s * inv).to(dt).unsqueeze(axis)
    return (v + a_sum.to(dt)).float() - mean.float()


class DuelingHead(nn.Module):
    """Q(s, a) = V(s) + A(s, a) - mean_a A(s, a), float32."""
    NAME = "DuelingHead_0"

    def __init__(self, fin: int, num_actions: int = NUM_ACTIONS,
                 noisy: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.value = _dense(noisy, fin, 1, dtype, (self.NAME, "value"))
        self.advantage = _dense(noisy, fin, num_actions, dtype,
                                (self.NAME, "advantage"))

    def forward(self, x, noise_key=None):
        return _dueling(self.value, self.advantage, x, noise_key, None)


class C51Head(nn.Module):
    """Categorical return-distribution logits [B, A, num_atoms], float32;
    ``dueling`` decomposes them per atom."""
    NAME = "C51Head_0"

    def __init__(self, fin: int, num_actions: int = NUM_ACTIONS,
                 num_atoms: int = 51, dueling: bool = False,
                 noisy: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.num_actions, self.num_atoms = num_actions, num_atoms
        self.dueling = dueling
        a, z = num_actions, num_atoms
        if dueling:
            self.value = _dense(noisy, fin, z, dtype, (self.NAME, "value"))
            self.advantage = _dense(noisy, fin, a * z, dtype,
                                    (self.NAME, "advantage"))
        else:
            self.logits = _dense(noisy, fin, a * z, dtype, (self.NAME, "logits"))

    def forward(self, x, noise_key=None):
        a, z = self.num_actions, self.num_atoms
        if self.dueling:
            return _dueling(self.value, self.advantage, x, noise_key, (a, z))
        # XLA keeps the plain head's bias sum in float32 but rounds the
        # noisy one's, whose bias is a fusion of its own
        out = _apply(self.logits, x, noise_key,
                     round_sum=isinstance(self.logits, NoisyDense))
        return out.reshape(out.shape[:-1] + (a, z)).float()


def _head(fin, num_actions, dueling, num_atoms, noisy, dtype):
    """(attribute name, module) of the output head, named as in flax."""
    if num_atoms > 0:
        return C51Head.NAME, C51Head(fin, num_actions, num_atoms, dueling,
                                     noisy, dtype)
    if dueling:
        return DuelingHead.NAME, DuelingHead(fin, num_actions, noisy, dtype)
    return "q", _dense(noisy, fin, num_actions, dtype, ("q",))


class _QNetwork(nn.Module):
    def _init_head(self, fin, num_actions, dueling, num_atoms, noisy, dtype):
        self.head_name, head = _head(fin, num_actions, dueling, num_atoms,
                                     noisy, dtype)
        self.add_module(self.head_name, head)

    def _head_out(self, x, noise_key):
        head = getattr(self, self.head_name)
        if self.head_name == "q":
            return _apply(head, x, noise_key, round_sum=False)
        return head(x, noise_key)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, Layer):
                m.reset_parameters(gen)


class NatureDQN(_QNetwork):
    """Mnih et al.'s conv trunk on [B, 84, 84, C] frames (C = channels x
    stacked frames; [B, 84, 84] is one channel), palette values scaled by
    1/255 in ``dtype``."""

    def __init__(self, obs_shape: Sequence[int], num_actions: int = NUM_ACTIONS,
                 dueling: bool = False, width_mult: int = 1,
                 num_atoms: int = 0, noisy: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        w = width_mult
        cin = obs_shape[-1] if len(obs_shape) == 3 else 1
        self.conv1 = Conv(cin, 32 * w, 8, 4, dtype)
        self.conv2 = Conv(32 * w, 64 * w, 4, 2, dtype)
        self.conv3 = Conv(64 * w, 64 * w, 3, 1, dtype)
        side = obs_shape[0]
        for k, s in ((8, 4), (4, 2), (3, 1)):
            side = (side - k) // s + 1
        self.dense = _dense(noisy, side * side * 64 * w, 512 * w, dtype,
                            ("dense",))
        self._init_head(512 * w, num_actions, dueling, num_atoms, noisy, dtype)

    def forward(self, x: torch.Tensor, noise_key=None) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]
        x = (x.to(self.dtype) / 255.0).permute(0, 3, 1, 2)   # NHWC -> NCHW
        for conv in (self.conv1, self.conv2, self.conv3):
            x = F.relu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)      # NHWC flatten
        x = F.relu(_apply(self.dense, x, noise_key))
        return self._head_out(x, noise_key).float()


class RamDQN(_QNetwork):
    """MLP Q-network on the (W, H) ram board (with stacked frames on a
    trailing axis), flattened."""

    def __init__(self, obs_shape: Sequence[int], num_actions: int = NUM_ACTIONS,
                 hidden: Sequence[int] = (512, 256), dueling: bool = False,
                 num_atoms: int = 0, noisy: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.hidden = tuple(hidden)
        sizes = (math.prod(obs_shape),) + self.hidden
        for i in range(len(self.hidden)):
            self.add_module(f"dense{i}", _dense(noisy, sizes[i], sizes[i + 1],
                                                dtype, (f"dense{i}",)))
        self._init_head(sizes[-1], num_actions, dueling, num_atoms, noisy, dtype)

    def forward(self, x: torch.Tensor, noise_key=None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(len(self.hidden)):
            x = F.relu(_apply(getattr(self, f"dense{i}"), x, noise_key))
        return self._head_out(x, noise_key).float()


def build_q_network(obs_type: str, obs_shape, dueling: bool = False,
                    width_mult: int = 1, num_atoms: int = 0,
                    noisy: bool = False, dtype=torch.bfloat16) -> nn.Module:
    """The model family for an observation shape: ``RamDQN`` for ram,
    ``NatureDQN`` for images. ``num_atoms > 0`` selects the C51 head."""
    if obs_type == "ram":
        return RamDQN(obs_shape, dueling=dueling, num_atoms=num_atoms,
                      noisy=noisy, dtype=dtype)
    return NatureDQN(obs_shape, dueling=dueling, width_mult=width_mult,
                     num_atoms=num_atoms, noisy=noisy, dtype=dtype)
