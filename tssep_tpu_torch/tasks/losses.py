"""Training losses: port of ``tssep_tpu/tasks/losses.py``.

``Loss`` keeps the target-naming protocol of the JAX package (``target`` is
the example key; capitalised names are STFT or frame domain, lower-case names
time domain). The time-domain losses (``MSE``, ``MAE``, ``LogMAE``, the
TS-SEP training loss) take estimates of (B?, speakers, samples) and have a
permutation-invariant form (``pit=True``) and a masked form for ragged
batches (``_sample_mask``); ``FreqMSE`` compares STFTs; ``VADSigmoidBCE``,
the TS-VAD training loss, takes the head's logits (B?, speakers, 1, frames,
freq) against frame activity ``Vad`` (B?, speakers, frames), with its
``pit`` form and its ``_frame_mask`` form; ``SignalAndVADSigmoidBCE`` adds a
signal loss to it for ``explicit_vad`` heads. A loss returns one value per
example for batched input, a scalar otherwise (MSE and FreqMSE as the JAX
package computes them). ``reads`` names the fields of the model's forward
output that a loss reads, so that a training forward computes only those.
"""

from __future__ import annotations

import itertools

import torch

from tssep_tpu_torch.utils.factory import factory_name

__all__ = ['Loss', 'TimeDomain', 'STFTDomain', 'MSE', 'MAE', 'LogMAE',
           'FreqMSE', 'VADSigmoidBCE', 'SignalAndVADSigmoidBCE',
           'masked_time_stats', 'pit_minimum', 'loss_from_config']


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

    #: The fields of the forward's output the loss reads.
    reads = frozenset()

    def targets(self, lower=False, upper=False):
        if lower:
            return (self.target.lower(),)
        if upper:
            return (self.target[0].upper() + self.target[1:],)
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

    def from_ex_out(self, ex, out, model=None):
        raise NotImplementedError


def _tensor(value, device, dtype=torch.float32):
    return torch.as_tensor(value, dtype=dtype, device=device)


class TimeDomain(Loss):
    reads = frozenset({'time_estimate'})

    def from_ex_out(self, ex, out, model=None):
        """The loss of ``out.time_estimate`` against ``ex[target]``, in
        float32 whatever the estimate's dtype."""
        estimate = out.time_estimate.float()
        target = _tensor(ex[self.target], estimate.device)
        mask = ex.get('_sample_mask')
        if mask is not None and not self.pit:
            mask = _tensor(mask, estimate.device)
            return self.reduce_time_masked(
                masked_time_stats(self.elementwise(estimate, target), mask))
        return self(estimate, target)

    def reduce_time_masked(self, per_spk):
        return per_spk.sum(dim=-1)


class STFTDomain(Loss):
    reads = frozenset({'stft_estimate'})

    def from_ex_out(self, ex, out, model=None):
        """The loss of ``out.stft_estimate`` against ``ex[target]``, which
        is the STFT of the lower-case target where ``ex`` lacks it (``ex``
        gains it, as in the JAX package)."""
        if not self.target[0].isupper():
            raise ValueError(f'{self.name} needs an STFT-domain target, got '
                             f'{self.target!r}')
        estimate = out.stft_estimate
        if self.target not in ex:
            ex[self.target] = model.fe.stft(_tensor(
                ex[self.target.lower()], estimate.device))
        target = torch.as_tensor(ex[self.target], device=estimate.device)
        return self(estimate, target)


class MSE(TimeDomain):
    """Mean over time, summed over speakers."""

    def loss_fn(self, estimate, target):
        return ((estimate - target) ** 2).mean(dim=-1).sum(dim=-1)

    def elementwise(self, e, t):
        return (e - t) ** 2


class MAE(TimeDomain):
    def loss_fn(self, estimate, target):
        return (estimate - target).abs().mean(dim=-1).sum(dim=-1)

    def elementwise(self, e, t):
        return (e - t).abs()


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


def _squared_magnitude(d):
    return (d * d.conj()).real if d.is_complex() else d ** 2


class FreqMSE(STFTDomain):
    def __init__(self, target='Speaker_reverberation_early', pit=False):
        super().__init__(target=target, pit=pit)

    def loss_fn(self, estimate, target):
        sq = _squared_magnitude(estimate - target)
        # mean over time (and frequency), summed over speakers
        if sq.dim() >= 3:
            sq = sq.mean(dim=-1)
        return sq.mean(dim=-1).sum(dim=-1)

    def elementwise(self, e, t):
        return _squared_magnitude(e - t)


def _bce_with_logits(x, z):
    """Numerically stable BCE with logits, elementwise."""
    return x.clamp(min=0) - x * z + torch.log1p(torch.exp(-x.abs()))


class VADSigmoidBCE(Loss):
    """Frame-level voice-activity BCE: the TS-VAD training loss.

    Estimate: logits (B?, spk, time, freq), averaged over freq; target:
    frame activity (B?, spk, time) (``Vad``), or one derived from a target
    signal by a magnitude threshold."""

    reads = frozenset({'logit'})

    def __init__(self, target='Vad', pit=False, magnitude_threshold=0.05):
        super().__init__(target=target, pit=pit)
        if not 0 < magnitude_threshold < 1:
            raise ValueError(f'magnitude_threshold {magnitude_threshold}')
        self.magnitude_threshold = magnitude_threshold

    def loss_fn(self, estimate, target):
        return _bce_with_logits(estimate, target).mean(dim=(-1, -2))

    def elementwise(self, e, t):
        return _bce_with_logits(e, t)

    def device_targets(self):
        # frame-domain 'Vad' only; the sample-domain activity stays host-side
        if self.target in ('vad', 'Vad'):
            return {'Vad'}
        return super().device_targets()

    def prepare_target(self, target):
        if self.target in ('vad', 'Vad'):
            return target
        t = target.abs().sum(dim=-1)
        t = t / t.amax(dim=-1, keepdim=True)
        return (t > self.magnitude_threshold).float()

    def __call__(self, estimate, target):
        if self.target not in ('vad', 'Vad'):
            if estimate.shape != target.shape or estimate.dim() <= 2:
                raise ValueError(f'estimate {tuple(estimate.shape)}, target '
                                 f'{tuple(target.shape)}')
            target = self.prepare_target(target)
        estimate = estimate.mean(dim=-1)
        if estimate.shape != target.shape:
            raise ValueError(f'estimate {tuple(estimate.shape)} and target '
                             f'{tuple(target.shape)} differ')
        if self.pit:
            s = estimate.shape[-2]
            pairwise = _bce_with_logits(estimate.unsqueeze(-2),
                                        target.unsqueeze(-3)).mean(dim=-1)
            return pit_minimum(pairwise, s) / s
        # mean over (time, speaker): one value per example
        return _bce_with_logits(estimate, target).mean(dim=(-1, -2))

    def from_ex_out(self, ex, out, model=None):
        """The loss of ``out.logit`` without its nmask axis against
        ``ex[target]`` (frame activity, made on the host by
        ``Model.host_prepare``); with ``_frame_mask``, the mean over the
        valid frames of each speaker."""
        if not self.target[0].isupper():
            raise ValueError(f'{self.name} needs a frame-domain target, got '
                             f'{self.target!r}')
        estimate = out.logit.squeeze(-3).float()
        target = _tensor(ex[self.target], estimate.device)
        frame_mask = ex.get('_frame_mask')
        if frame_mask is not None and not self.pit:
            frame_mask = _tensor(frame_mask, estimate.device)
            bce = _bce_with_logits(estimate.mean(dim=-1), target) * frame_mask
            counts = frame_mask.sum(dim=-1).clamp(min=1.0)
            return (bce.sum(dim=-1) / counts).mean(dim=-1)
        return self(estimate, target)


class SignalAndVADSigmoidBCE(VADSigmoidBCE):
    """The VAD loss of an ``explicit_vad`` head's ``vad_logit`` plus a
    signal loss, each weighted."""

    def __init__(self, signal_loss, target='Vad', pit=False,
                 magnitude_threshold=0.05, vad_weight=1.0, signal_weight=1.0):
        super().__init__(target=target, pit=pit,
                         magnitude_threshold=magnitude_threshold)
        if isinstance(signal_loss, dict):
            signal_loss = loss_from_config(signal_loss)
        self.signal_loss = signal_loss
        self.vad_weight = float(vad_weight)
        self.signal_weight = float(signal_weight)
        self.reads = frozenset({'vad_logit'}) | signal_loss.reads

    def targets(self, lower=False, upper=False):
        return (super().targets(lower=lower, upper=upper)
                + self.signal_loss.targets(lower=lower, upper=upper))

    def device_targets(self):
        return ({'Vad'} if self.target in ('vad', 'Vad')
                else Loss.device_targets(self)) \
            | self.signal_loss.device_targets()

    def from_ex_out(self, ex, out, model=None):
        signal_loss = self.signal_loss.from_ex_out(ex, out, model)
        estimate = out.vad_logit[..., None].squeeze(-3).float()
        target = _tensor(ex[self.target], estimate.device)
        return (self.vad_weight * self(estimate, target)
                + self.signal_weight * signal_loss)


_LOSSES = {cls.__name__: cls for cls in (
    MSE, MAE, LogMAE, FreqMSE, VADSigmoidBCE, SignalAndVADSigmoidBCE)}


def loss_from_config(config=None) -> Loss:
    """A loss from the JAX configuration's form, ``{'factory': name,
    **kwargs}`` with the class's name or dotted path; ``LogMAE()`` for
    None, as the JAX ``Model`` defaults (``tssep_tpu/tasks/model.py:88``).
    ``SignalAndVADSigmoidBCE``'s ``signal_loss`` may be such a form too."""
    if config is None:
        return LogMAE()
    config = dict(config)
    name = factory_name(config.pop('factory', 'LogMAE'))
    if name not in _LOSSES:
        raise ValueError(f'unknown loss {name!r}')
    return _LOSSES[name](**config)
