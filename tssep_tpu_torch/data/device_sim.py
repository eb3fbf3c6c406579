"""On-device meeting simulation: port of ``tssep_tpu/data/device_sim.py``.

A training batch is made on the card from a ``torch.Generator``: harmonic
'speakers' (log-uniform f0, per-speaker timbre amplitudes, random phases and
amplitude modulation), the staircase overlap layout, noise scaled to an SNR,
and gate-style enrollment embeddings from an enrollment STFT. Nothing crosses
from the host but the generator's seed.

``generate`` is split in two: ``draw`` makes every random tensor, and
``from_draws`` builds the batch from them and draws nothing. The JAX
package's PRNG streams cannot be reproduced in torch, so the tests hand
JAX's draws to ``from_draws`` and compare its batch with JAX's ``generate``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from tssep_tpu_torch.data.dummy import staircase_vad
from tssep_tpu_torch.dist.mesh import RowShard, ShardedGenerator, batch_rand
from tssep_tpu_torch.signal.stft import STFT
from tssep_tpu_torch.signal.vad import stft_vad
from tssep_tpu_torch.utils.device import resolve_device

__all__ = ['DeviceMeetingSimulator', 'DeviceSimDataset']


@dataclasses.dataclass(frozen=True)
class DeviceMeetingSimulator:
    sample_rate: int = 16000
    duration: float = 5.0
    num_speakers: int = 8
    aux_size: int = 513
    snr_db: float = 10.0
    n_harmonics: int = 8
    f0_min: float = 90.0
    f0_max: float = 900.0
    enroll_seconds: float = 1.0

    @property
    def num_samples(self):
        return int(self.sample_rate * self.duration)

    @property
    def num_enroll_samples(self):
        return int(self.sample_rate * self.enroll_seconds)

    @functools.cached_property
    def _vad(self):
        return staircase_vad(self.num_samples, self.num_speakers)

    @functools.cached_property
    def _frame_vad(self):
        return stft_vad(self._vad, 1024, 256, True).astype(np.float32)

    @functools.cached_property
    def _gate_stft(self):
        size = 2 * (self.aux_size - 1)
        return STFT(size=size, shift=size // 4, window='hann')

    # ------------------------------------------------------------------
    def _source_draws(self, generator, batch, prefix):
        s, h = self.num_speakers, self.n_harmonics

        def uniform(shape, low, high):
            return low + (high - low) * batch_rand(generator, shape)

        return {f'{prefix}_phases': uniform((batch, s, h), 0, 2 * np.pi),
                f'{prefix}_am_f': uniform((batch, s, 1), 1.0, 4.0),
                f'{prefix}_am_p': uniform((batch, s, 1), 0, 2 * np.pi)}

    def draw(self, generator: torch.Generator, batch: int) -> dict:
        """Every random tensor of one batch, on the generator's device: f0s
        (B, S), amps (B, S, H), the phases and modulation of the sources
        (``src_*``) and of the enrollment (``enr_*``), noise (B, samples)."""
        s, h = self.num_speakers, self.n_harmonics
        dev = generator.device
        u = batch_rand(generator, (batch, s))
        lo, hi = math.log(self.f0_min), math.log(self.f0_max)
        draws = {'f0s': torch.exp(lo + (hi - lo) * u)}
        amps = 0.05 + 0.95 * batch_rand(generator, (batch, s, h))
        draws['amps'] = amps / torch.arange(1, h + 1, device=dev)
        draws.update(self._source_draws(generator, batch, 'src'))
        draws.update(self._source_draws(generator, batch, 'enr'))
        draws['noise'] = batch_rand(generator, (batch, self.num_samples),
                                    torch.randn)
        return draws

    def _sources(self, num_samples, f0s, amps, phases, am_f, am_p):
        """Harmonic sources (B, S, num_samples) from f0s (B, S), amps and
        phases (B, S, H), am_f and am_p (B, S, 1)."""
        h = self.n_harmonics
        t = torch.arange(num_samples, dtype=torch.float32,
                         device=f0s.device) / self.sample_rate
        freqs = f0s[..., None] * torch.arange(1, h + 1, device=f0s.device)
        alive = (freqs < 0.95 * self.sample_rate / 2).float()
        coeff = amps * alive                                  # (B, S, H)
        # The harmonic bank by the complex-exponential power chain:
        # sin(k w t + p_k) = cos(p_k) Im(z^k) + sin(p_k) Re(z^k) with
        # z = e^{i w t}: one sin and one cos per (B, S, T) element and a
        # complex product per harmonic, not H sines over (B, S, H, T).
        ang = (2 * np.pi) * f0s[..., None] * t                # (B, S, T)
        zr, zi = torch.cos(ang), torch.sin(ang)
        cp, sp = torch.cos(phases), torch.sin(phases)         # (B, S, H)
        hr, hi = zr, zi
        sig = coeff[..., 0, None] * (cp[..., 0, None] * hi
                                     + sp[..., 0, None] * hr)
        for k in range(1, h):
            hr, hi = hr * zr - hi * zi, hr * zi + hi * zr     # z^(k+1)
            sig = sig + coeff[..., k, None] * (cp[..., k, None] * hi
                                               + sp[..., k, None] * hr)
        am = 0.5 + 0.5 * torch.sin(2 * np.pi * am_f * t + am_p)
        return sig * am

    def _gate_embedding(self, enroll):
        """enroll: (B, S, T_e) -> (B, S, aux_size) in [0, 1]."""
        spec = self._gate_stft.stft(enroll).abs()
        profile = (spec ** 2).mean(dim=-2)
        padded = torch.nn.functional.pad(profile, (1, 1))
        profile = (padded[..., :-2] + padded[..., 1:-1] + padded[..., 2:]) / 3
        gate = profile / profile.amax(dim=-1, keepdim=True).clamp(min=1e-12)
        return torch.sqrt(gate)

    def from_draws(self, draws: dict) -> dict:
        """The batch (observation, auxInput, Vad, the per-speaker target)
        from the tensors of :meth:`draw`, on their device."""
        f0s, amps = draws['f0s'], draws['amps']
        dev = f0s.device
        sources = self._sources(self.num_samples, f0s, amps,
                                draws['src_phases'], draws['src_am_f'],
                                draws['src_am_p'])
        vad = torch.as_tensor(self._vad, dtype=torch.float32, device=dev)
        gated = sources * vad[None]
        speech = gated.sum(dim=1)                             # (B, T)
        noise = draws['noise']
        speech_power = (speech ** 2).mean(dim=-1, keepdim=True) + 1e-12
        noise = noise * torch.sqrt(
            speech_power / (noise ** 2).mean(dim=-1, keepdim=True)
            / (10 ** (self.snr_db / 10)))
        enroll = self._sources(self.num_enroll_samples, f0s, amps,
                               draws['enr_phases'], draws['enr_am_f'],
                               draws['enr_am_p'])
        frame_vad = torch.as_tensor(self._frame_vad, device=dev)
        batch = f0s.shape[0]
        return {
            'observation': (speech + noise)[:, None, :],      # (B, 1, T)
            'auxInput': self._gate_embedding(enroll).float(),
            'Vad': frame_vad[None].expand((batch,) + frame_vad.shape),
            'speaker_reverberation_early_ch0': gated,
            'reference_channel': 0,
        }

    def generate(self, generator: torch.Generator, batch: int) -> dict:
        """One batch, made on the generator's device."""
        return self.from_draws(self.draw(generator, batch))


class DeviceSimDataset:
    """Infinite batches from the simulator, drawn from one generator seeded
    with ``seed`` on ``device`` (the card unless the caller passes 'cpu').
    Keys that are neither inputs nor in ``targets`` are dropped. With a
    ``shard`` (``dist.mesh.RowShard``), ``batch`` is the global batch and
    each batch is the shard's rows of it (``batch // shard.size``), drawn
    as one process draws them."""

    def __init__(self, simulator: DeviceMeetingSimulator, batch: int,
                 seed: int = 0, targets=('Vad',), device='cuda',
                 shard: RowShard | None = None):
        self.simulator = simulator
        self.batch = batch
        self.seed = seed
        self.targets = set(targets)
        self.device = resolve_device(device)
        self.shard = shard

    def __iter__(self):
        if self.shard is None:
            generator = torch.Generator(device=self.device)
            batch = self.batch
        else:
            batch = self.shard.local(self.batch)
            generator = ShardedGenerator(self.device, self.shard, batch)
        generator.manual_seed(self.seed)
        while True:
            ex = self.simulator.generate(generator, batch)
            for key in ('Vad', 'speaker_reverberation_early_ch0'):
                if key not in self.targets:
                    ex.pop(key)
            ex['dataset'] = ['train'] * batch
            yield ex
