"""Parameter-free normalizers: port of ``tssep_tpu/nn/norm.py``."""

from __future__ import annotations

import math

import torch

from tssep_tpu_torch.utils.factory import factory_name

__all__ = ['InstanceNorm', 'InstanceNorm_v2', 'norm_from_config']


class InstanceNorm:
    """(x - mean) / std along ``dim`` (the biased std by default, like
    torch's ``InstanceNorm1d``)."""

    def __init__(self, dim=-1, unbiased=False):
        self.dim = dim
        self.unbiased = unbiased

    def __call__(self, x):
        mean = x.mean(dim=self.dim, keepdim=True)
        std = x.std(dim=self.dim, keepdim=True,
                    correction=1 if self.unbiased else 0)
        return (x - mean) / std


class InstanceNorm_v2:
    """Mean-subtract along ``mean_dim``, then divide by the rms along
    ``norm_dim``."""

    def __init__(self, mean_dim=-1, norm_dim=-1):
        self.mean_dim = mean_dim
        self.norm_dim = norm_dim

    def __call__(self, x):
        x = x - x.mean(dim=self.mean_dim, keepdim=True)
        norm = torch.linalg.vector_norm(x, dim=self.norm_dim, keepdim=True)
        return x / (norm / math.sqrt(x.shape[self.norm_dim]))


_CLASSES = {'InstanceNorm': InstanceNorm, 'InstanceNorm_v2': InstanceNorm_v2}


def norm_from_config(config):
    """A normalizer from the JAX configuration's form, ``{'factory': name,
    **kwargs}`` with the class's name or dotted path; None and instances
    pass through."""
    if config is None or not isinstance(config, dict):
        return config
    config = dict(config)
    name = factory_name(config.pop('factory'))
    if name not in _CLASSES:
        raise ValueError(f'unknown normalizer {name!r}')
    return _CLASSES[name](**config)
