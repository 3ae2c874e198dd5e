"""A noisy layer's noisy weight and bias on the card: CUDA noise kernel
(``csrc/noise.cu``).

``noisy_weights`` takes the network's noise key, the layer's fold constant
(``threefry.flax_fold`` of its flax path and rng counter) and its
parameters, and returns (weight, bias) from one launch, bitwise what
``models.dqn.NoisyDense.noisy_weights`` computes with the plain threefry:
the layer key, its split, the two ``threefry.normal`` vectors under
``f(e) = sign(e) sqrt(|e|)`` and the weights ``sigma * eps + mu`` rounded
once from float64. With ``at`` / rows of a model-axis rank's block, the
weight is those rows of the whole layer's; the bias is always whole.

The weights are differentiable in mu and sigma: the backward gives
``grad_sigma = grad_w * eps`` (a float32 product, ``eps`` the outer
product of the noise vectors the kernel also writes) and ``grad_mu =
grad_w``, for the weight and the bias alike: bitwise what autograd gives
through the plain version's float64 round trip, since the product of two
float32 is exact in float64 and is rounded once.

``NoisyDense`` calls it for CUDA parameters; CPU parameters take the plain
version. The counter ``kernel.noise.launches`` (``utils/profiling.py``)
counts its launches: one a layer a noisy forward.
"""

from __future__ import annotations

import torch

from ..utils.profiling import count
from . import _build
from .cuda_step import _stream, check_tensor

_F32 = torch.float32
_I32 = torch.int32
_KEY = torch.Size((2,))


def _launch(key, fold, w_mu, w_sigma, b_mu, b_sigma, at):
    """(w, b, e) from one launch: e is e_in then e_out, float32[in_f +
    features]."""
    rows, in_f = w_mu.shape
    features = b_mu.shape[0]
    index = key.get_device()
    w = torch.empty_like(w_mu)
    b = torch.empty_like(b_mu)
    e = torch.empty(in_f + features, dtype=_F32, device=key.device)
    err = _build.load_library().tetris_noise_launch(
        key.data_ptr(), fold, w_mu.data_ptr(), w_sigma.data_ptr(),
        b_mu.data_ptr(), b_sigma.data_ptr(), w.data_ptr(), b.data_ptr(),
        e.data_ptr(), in_f, features, at, rows, index, _stream(index))
    if err != 0:
        raise RuntimeError(f"noise kernel launch failed: CUDA error {err}")
    count("kernel.noise.launches")
    return w, b, e


class _NoisyWeights(torch.autograd.Function):
    """(w, b) of the kernel, differentiable in the mus and sigmas."""

    @staticmethod
    def forward(ctx, w_mu, w_sigma, b_mu, b_sigma, key, fold, at):
        w, b, e = _launch(key, fold, w_mu, w_sigma, b_mu, b_sigma, at)
        ctx.save_for_backward(e)
        ctx.at, ctx.rows, ctx.in_f = at, w_mu.shape[0], w_mu.shape[1]
        return w, b

    @staticmethod
    def backward(ctx, gw, gb):
        e, = ctx.saved_tensors
        e_in, e_out = e[:ctx.in_f], e[ctx.in_f:]
        eps = torch.outer(e_out[ctx.at:ctx.at + ctx.rows], e_in)
        return gw, gw * eps, gb, gb * e_out, None, None, None


def noisy_weights(key: torch.Tensor, fold: int, w_mu: torch.Tensor,
                  w_sigma: torch.Tensor, b_mu: torch.Tensor,
                  b_sigma: torch.Tensor, at: int = 0):
    """(weight [rows, in_f], bias [features]) of a noisy layer under the
    network's noise ``key`` (int32[2]) on the card: ``w_mu`` / ``w_sigma``
    are the rows [at, at + rows) of the layer's weights, ``b_mu`` /
    ``b_sigma`` its whole biases, all float32 on ``key``'s card."""
    named = (("key", key, _I32), ("weight_mu", w_mu, _F32),
             ("weight_sigma", w_sigma, _F32), ("bias_mu", b_mu, _F32),
             ("bias_sigma", b_sigma, _F32))
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    dev = key.device
    if dev.type != "cuda":
        raise ValueError(f"the noise kernel runs on a CUDA device; the key "
                         f"is on {dev}")
    rows, in_f = w_mu.shape
    features = b_mu.shape[0]
    shapes = (_KEY, (rows, in_f), (rows, in_f), (features,), (features,))
    for (name, t, dtype), shape in zip(named, shapes):
        check_tensor(name, t, shape, dtype, dev)
    if not (0 <= at and at + rows <= features):
        raise ValueError(f"rows [{at}, {at + rows}) outside the layer's "
                         f"{features} features")
    return _NoisyWeights.apply(w_mu, w_sigma, b_mu, b_sigma, key, fold, at)
