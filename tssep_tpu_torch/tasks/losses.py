"""Training losses: port of the part of ``tssep_tpu/tasks/losses.py`` that the
flagship's training step uses.

``Loss`` keeps the target-naming protocol of the JAX package (``target`` is
the example key; capitalised names are STFT or frame domain, lower-case names
time domain). ``LogMAE``, the TS-SEP training loss, is ported with its
permutation-invariant form (``pit=True``) and its masked form for ragged
batches (``_sample_mask``). Estimates are (B?, speakers, samples); a loss
returns one value per example for batched input, a scalar otherwise.

The other losses of the JAX package are not ported yet: naming one in a
configuration raises ``NotImplementedError``.
"""

from __future__ import annotations

import itertools

import torch

__all__ = ['Loss', 'TimeDomain', 'LogMAE', 'masked_time_stats',
           'pit_minimum', 'loss_from_config']


def pit_minimum(pairwise, speakers: int):
    """Min over permutations of sum_s pairwise[..., s, perm[s]].

    ``pairwise``: (..., S, S) loss of (estimate s, target t). Enumerates
    the S! permutations (40320 for S = 8)."""
    perms = torch.tensor(list(itertools.permutations(range(speakers))),
                         device=pairwise.device)                # (P, S)
    rows = torch.arange(speakers, device=pairwise.device)
    return pairwise[..., rows, perms].sum(dim=-1).amin(dim=-1)


def masked_time_stats(elementwise, sample_mask):
    """Masked mean over time per speaker. elementwise: (..., spk, T);
    sample_mask: broadcastable (..., 1, T) with 1 on valid samples."""
    counts = sample_mask.sum(dim=-1).clamp(min=1.0)
    return (elementwise * sample_mask).sum(dim=-1) / counts


class Loss:
    """Base loss with the JAX package's target-naming protocol."""

    def __init__(self, target='speaker_reverberation_early_ch0', pit=False):
        self.target = target
        self.pit = pit

    @property
    def name(self):
        return type(self).__name__

    def targets(self, lower=False):
        if lower:
            return (self.target.lower(),)
        return (self.target,)

    def device_targets(self):
        """Example keys the loss reads."""
        return set(self.targets()) | set(self.targets(lower=True))

    def loss_fn(self, estimate, target):
        raise NotImplementedError

    def elementwise(self, e, t):
        raise NotImplementedError

    def reduce_pit(self, summed):
        return summed

    def __call__(self, estimate, target):
        if estimate.shape != target.shape:
            raise ValueError(f'estimate {tuple(estimate.shape)} and target '
                             f'{tuple(target.shape)} differ')
        if self.pit:
            return self._pit(estimate, target)
        return self.loss_fn(estimate, target)

    def _pit(self, estimate, target):
        pairwise = self.elementwise(estimate.unsqueeze(-2),
                                    target.unsqueeze(-3)).mean(dim=-1)
        return self.reduce_pit(pit_minimum(pairwise, estimate.shape[-2]))

    def from_ex_out(self, ex, out):
        raise NotImplementedError


class TimeDomain(Loss):
    def from_ex_out(self, ex, out):
        """The loss of ``out.time_estimate`` against ``ex[target]``, in
        float32 whatever the estimate's dtype."""
        estimate = out.time_estimate.float()
        target = torch.as_tensor(ex[self.target], dtype=torch.float32,
                                 device=estimate.device)
        mask = ex.get('_sample_mask')
        if mask is not None and not self.pit:
            mask = torch.as_tensor(mask, dtype=torch.float32,
                                   device=estimate.device)
            return self.reduce_time_masked(
                masked_time_stats(self.elementwise(estimate, target), mask))
        return self(estimate, target)

    def reduce_time_masked(self, per_spk):
        return per_spk.sum(dim=-1)


class LogMAE(TimeDomain):
    """``log10(sum_spk mean_t |e - t|)``: the TS-SEP training loss."""

    def loss_fn(self, estimate, target):
        return torch.log10((estimate - target).abs().mean(dim=-1).sum(dim=-1))

    def elementwise(self, e, t):
        return (e - t).abs()

    def reduce_pit(self, summed):
        return torch.log10(summed)

    def reduce_time_masked(self, per_spk):
        return torch.log10(per_spk.sum(dim=-1))


_PORTED = {'LogMAE': LogMAE}
_NOT_PORTED = ('MSE', 'MAE', 'FreqMSE', 'VADSigmoidBCE',
               'SignalAndVADSigmoidBCE')


def loss_from_config(config=None) -> Loss:
    """A loss from the JAX configuration's form, ``{'factory': name,
    **kwargs}`` with the class's name or dotted path; ``LogMAE()`` for
    None, as the JAX ``Model`` defaults (``tssep_tpu/tasks/model.py:88``)."""
    if config is None:
        return LogMAE()
    config = dict(config)
    name = str(config.pop('factory', 'LogMAE')).rsplit('.', 1)[-1]
    if name in _NOT_PORTED:
        raise NotImplementedError(f'loss {name} is not ported yet')
    if name not in _PORTED:
        raise ValueError(f'unknown loss {name!r}')
    return _PORTED[name](**config)
