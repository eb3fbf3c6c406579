"""Parameter initialisers with torch's default distributions, drawn from an
explicit ``torch.Generator`` (port of ``tssep_tpu/nn/init.py``: the same
distributions as the JAX package, not the same numbers).

- ``torch.nn.Linear``: weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
- ``torch.nn.LSTM``: every tensor U(-1/sqrt(hidden), 1/sqrt(hidden)).

Values are drawn as float32 on the generator's device and copied into the
parameter, so a seed gives the same weights on every device.
"""

from __future__ import annotations

import math

import torch

__all__ = ['uniform_', 'linear_init_', 'lstm_init_']


@torch.no_grad()
def uniform_(param: torch.Tensor, bound: float, generator: torch.Generator):
    draw = torch.rand(param.shape, generator=generator,
                      device=generator.device, dtype=torch.float32)
    param.copy_((2 * draw - 1) * bound)
    return param


def linear_init_(linear: torch.nn.Linear, generator: torch.Generator):
    bound = 1.0 / math.sqrt(linear.in_features)
    uniform_(linear.weight, bound, generator)
    if linear.bias is not None:
        uniform_(linear.bias, bound, generator)


def lstm_init_(layer: torch.nn.Module, hidden_size: int,
               generator: torch.Generator):
    bound = 1.0 / math.sqrt(hidden_size)
    for param in layer.parameters():
        uniform_(param, bound, generator)
