"""Task assembly: port of ``tssep_tpu/tasks/model.py``. Feature extraction,
mask estimator, enhancer and loss, plus the data pipeline the model owns
(reference ``tssep/train/model.py``).

- **host side** (numpy): dataset construction (``prepare_dataset`` and the
  ``prepare_*_dataset`` wrappers), target selection, ``collate_fn`` with
  the ragged-length masks ``_sample_mask`` / ``_frame_mask``,
  ``host_prepare`` (sample VAD -> frame ``Vad``), ``example_to_device``
  (to an explicit ``torch.device``);
- **device side**: ``forward`` runs observation -> STFT -> features -> mask
  estimator -> enhancer, and synthesises the separated waveforms with the
  ISTFT of the enhanced STFT; ``review_loss`` applies the loss; ``loss_fn``
  is what the trainer differentiates.

A batch has the layout of ``collate_fn``'s (or ``DeviceMeetingSimulator``'s):
``observation`` (B, C, samples), ``auxInput`` (B, S, A) and
``reference_channel``, and for training the loss's target (for example
``speaker_reverberation_early_ch0``, (B, S, samples), or the frame activity
``Vad``, (B, S, frames)). A batch may instead bring its ``Observation`` (the
STFT) or its ``Input`` (the features); without an ``Observation`` there is
no estimate, and only ``VADSigmoidBCE`` can train it. Serving
(``training=False``) runs without autograd and returns every output;
training keeps the graph and computes only the outputs the loss reads
(``Loss.reads``).

The model is a factory configuration (``config/configurable.py``):
``finalize_dogmatic_config`` derives the estimator's ``idim``, ``odim`` and
``nmask`` from the feature extractor and the enhancer, as the JAX class does
(:61-99). ``from_config`` builds the JAX configuration's form (the flagship
of ``bench.py:98-106``, a recipe's ``eg.trainer.model``) through that route,
with the port-only options (storage type, device, kernel switches).

``add_snapshots`` / ``snapshots`` make the audio, spectrogram and mask
payloads of a validation forward (reference ``model.py:692-752``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import typing

import numpy as np
import torch
from torch import nn

from tssep_tpu_torch.config.configurable import (
    Configurable, from_config, get_config, import_class)
from tssep_tpu_torch.data.dummy import DummyReader
from tssep_tpu_torch.dist import multihost
from tssep_tpu_torch.features import extractor as feature_extractor
from tssep_tpu_torch.nn.estimator import MaskEstimator
from tssep_tpu_torch.signal.vad import stft_vad
from tssep_tpu_torch.tasks import enhancer as enhancer_mod
from tssep_tpu_torch.tasks import losses as loss_mod
from tssep_tpu_torch.utils.device import resolve_device

__all__ = ['Model', 'ForwardOutput']


@dataclasses.dataclass
class ForwardOutput:
    mask: typing.Any
    logit: typing.Any
    embedding: typing.Any = None
    stft_estimate: typing.Any = None
    time_estimate: typing.Any = None
    vad_mask: typing.Any = None
    vad_logit: typing.Any = None


#: example keys that are transferred to the device (everything else stays
#: on the host)
_DEVICE_KEY_BASE = ('Input', 'observation', 'auxInput', 'framewise_embeddings',
                    '_sample_mask', '_frame_mask')


def _identity(ex):
    return ex


def _host(x):
    """A tensor (or array) as a numpy array; bfloat16, which numpy lacks,
    as float32."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Model(nn.Module, Configurable):
    """Feature extractor + reader + mask estimator + enhancer + loss."""

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['fe'] = dict(
            factory=feature_extractor.Log1pMaxNormAbsSTFT,
            size=1024, shift=256, window='hann',
        )
        config['reader'] = dict(factory=DummyReader)
        config['enhancer'] = dict(factory=enhancer_mod.Masking)

        # instantiate the fe to derive the estimator's dimensions (mirrors
        # reference model.py:133-146)
        fe_cfg = config['fe'].to_dict()
        fe_obj = from_config(get_config(fe_cfg['factory'], {
            k: v for k, v in fe_cfg.items() if k != 'factory'}))

        enh_factory = import_class(config['enhancer']['factory'])
        config['mask_estimator'] = dict(
            factory=MaskEstimator,
            idim=fe_obj.output_size,
            odim=fe_obj.frequencies,
            nmask=1 if issubclass(enh_factory, enhancer_mod.Masking) else 2,
        )
        config['loss'] = dict(factory=loss_mod.LogMAE)

    def __init__(self, fe, reader, mask_estimator: MaskEstimator, enhancer,
                 loss, *, device='cuda'):
        super().__init__()
        self.device = resolve_device(device)
        self.fe = fe
        self.reader = reader
        self.mask_estimator = mask_estimator.to(self.device)
        self.enhancer = enhancer
        self.loss = loss
        #: The reader's ``data_hooks.pre_net``: a function of the example
        #: after its features are made (``DummyReader``'s is the identity).
        hooks = getattr(reader, 'data_hooks', None)
        self.pre_net_hook = getattr(hooks, 'pre_net', _identity)

    @classmethod
    def from_config(cls, config: dict, *, storage_dtype=torch.bfloat16,
                    head_dtype=torch.float32, device='cuda', cond_fuse=False,
                    fullfuse=True, spill=False, bidi=True):
        """Build from a config of the JAX package's form (the flagship of
        ``bench.py:98-106``, a recipe's ``eg.trainer.model``): the complete
        configuration (``get_config``: ``fe`` without another factory takes
        the JAX ``Model``'s default extractor's settings, the estimator's
        dimensions follow the features and the enhancer), then
        ``from_config`` with the port-only options.

        ``cond_fuse``, ``fullfuse``, ``spill`` and ``bidi`` choose kernels,
        as the JAX package's ``TSSEP_PALLAS_CONDFUSE``,
        ``TSSEP_PALLAS_FULLFUSE``, ``TSSEP_PALLAS_SPILL`` and
        ``TSSEP_PALLAS_BIDI`` do (``MaskEstimator``): ``cond_fuse=True``
        forms the 'mul' conditioning inside the first post-net layer's
        kernels; ``fullfuse=False`` runs every BLSTM layer from gate inputs
        computed outside; ``spill=True`` runs every fully fused layer
        through the spill pair, which keeps the c carry of every 8th step
        for the backward instead of the c sequence; ``bidi=False`` runs
        each direction of a layer that takes gate inputs on its own. None
        changes the parameters, so the same named arrays load
        (``compat/from_jax.py``) whatever the switches.

        ``head_dtype`` bfloat16 is JAX's ``TSSEP_HEAD_BF16=1``: the head's
        logits and masks in bfloat16 (``MaskEstimator``), and the forward's
        synthesis of the waveforms from bfloat16 segments
        (``STFT.istft``); the losses take float32."""
        device = resolve_device(device)
        config = dict(config)
        factory = import_class(config.pop('factory', cls))
        if not (isinstance(factory, type) and issubclass(factory, Model)):
            raise ValueError(f'factory {factory!r} is not a Model')
        unknown = set(config) - {'fe', 'reader', 'mask_estimator',
                                 'enhancer', 'loss'}
        if unknown:
            raise ValueError(f'unknown config keys {sorted(unknown)}')
        return from_config(get_config(factory, config),
                           storage_dtype=storage_dtype,
                           head_dtype=head_dtype, device=device,
                           cond_fuse=cond_fuse, fullfuse=fullfuse,
                           spill=spill, bidi=bidi)

    # ------------------------------------------------------------------
    # Data pipeline (host)
    # ------------------------------------------------------------------
    @property
    def _device_keys(self):
        return set(_DEVICE_KEY_BASE) | self.loss.device_targets()

    def example_to_device(self, ex, device=None):
        """``ex`` with the arrays the device reads (``_device_keys``) as
        float32 tensors on ``device`` (default: the model's)."""
        device = self.device if device is None else torch.device(device)
        out = dict(ex)
        for k in self._device_keys:
            if k in out and isinstance(out[k], np.ndarray):
                arr = out[k]
                if arr.dtype == np.float64:
                    arr = arr.astype(np.float32)
                out[k] = torch.as_tensor(arr, device=device)
        return out

    def host_prepare(self, ex: dict) -> dict:
        """Host-side target preparation: a sample-domain ``vad`` (S,
        samples) becomes the frame activity ``Vad`` that ``VADSigmoidBCE``
        reads, where the loss wants it and ``ex`` lacks it
        (``tssep_tpu/tasks/model.py:122-134``)."""
        if 'Vad' in self.loss.targets() and 'Vad' not in ex and 'vad' in ex:
            if hasattr(self.fe, 'sample_vad_to_frame_vad'):
                # waveform extractors (KaldiMFCC) frame the samples their way
                frames = self.fe.sample_vad_to_frame_vad(np.asarray(ex['vad']))
            else:
                frames = stft_vad(np.asarray(ex['vad']), self.fe.window_length,
                                  self.fe.shift, self.fe.fading)
            ex['Vad'] = np.asarray(frames, dtype=np.float32)
        return ex

    def prepare_dataset(
        self, dataset_name, device=None, training=False, review=True,
        batch_size=None, prefetch=True, reader=None, sort=False,
        verbose=False, load_keys=None, host_shard=False, drop_last=False,
    ):
        """The reader's ``dataset_name`` as model examples
        (``tssep_tpu/tasks/model.py:142-247``): targets selected, shuffled
        when ``training`` (unless sorted longest first), dealt round-robin
        to this process with ``host_shard`` (``dist.multihost``), batched
        and collated with ``batch_size``, prefetched on threads (a failing
        example is dropped), and moved to ``device`` (the model's by
        default; ``False`` leaves them on the host)."""
        if reader is None:
            reader = self.reader

        if sort:
            def pre_load_apply(ds):
                def get_num_samples(ex):
                    try:
                        return ex['end'] - ex['start']
                    except KeyError:
                        pass
                    ns = ex.get('num_samples')
                    if isinstance(ns, dict):
                        return ns.get('observation',
                                      max(ns.get('original_source', [0])))
                    return ns
                return ds.copy(freeze=True).sort(get_num_samples, reverse=True)
        else:
            pre_load_apply = None

        if load_keys is None:
            load_keys = ['observation', *self.loss.targets(lower=True)]

        ds = reader(dataset_name, pre_load_apply=pre_load_apply,
                    load_keys=load_keys)

        training_flag = training

        def prepare(ex):
            r = {'reference_channel': 0}
            try:
                r['observation'] = ex['audio_data']['observation']
            except KeyError:
                if 'Input' in ex:
                    r['Input'] = ex['Input']
                else:
                    raise

            for target_name in self.loss.targets():
                target_name_lower = target_name.lower()
                try:
                    if target_name_lower in ex['audio_data']:
                        target = ex['audio_data'][target_name_lower]
                        if isinstance(target, np.ndarray) and target.ndim == 3:
                            target = target[:, r['reference_channel']]
                        r[target_name_lower] = target
                    elif target_name in ('Vad',):
                        if target_name in ex['audio_data']:
                            r[target_name] = ex['audio_data'][target_name]
                    elif review:
                        raise KeyError(
                            f'Reader did not load {target_name_lower!r} '
                            f'(set review=False to allow missing targets)')
                except KeyError:
                    if training_flag:
                        raise

            for k in ('example_id', 'dataset', 'gender', 'auxInput', 'vad',
                      'transcription', 'speaker_ids',
                      'framewise_embeddings', 'framewise_embeddings_stride'):
                if k in ex:
                    r[k] = ex[k]
                elif k == 'vad' and 'vad' in ex.get('audio_data', {}):
                    r[k] = ex['audio_data']['vad']

            r = self.host_prepare(r)
            if verbose:
                r['verbose'] = ex
            return r

        ds = ds.map(prepare)

        if training and not sort:
            ds = ds.shuffle(reshuffle=True)

        if host_shard:
            # Multi-process: deal examples round-robin by rank AFTER the
            # (seed-deterministic, process-identical) shuffle, so the union
            # of all ranks' local batches is exactly the global batch one
            # process would see (tests/test_torch_port_multihost.py
            # compares the trajectories).
            ds = multihost.host_shard_dataset(ds)

        if batch_size is not None:
            ds = ds.batch(batch_size, drop_last=drop_last)
            ds = ds.map(self.collate_fn)

        if prefetch:
            threads = int(os.environ.get('SLURM_CPUS_PER_TASK', 6))
            ds = ds.prefetch(threads, threads * 2, catch_filter_exception=True)
        elif training:
            ds = ds.catch()

        if device is not False:
            ds = ds.map(lambda ex: self.example_to_device(ex, device))
        return ds

    #: Padded (bucketed) lengths are rounded up to this many STFT shifts so
    #: a batch of variable-length examples takes few distinct shapes.
    pad_shift_multiple = 32

    def _pad_time(self, arrays, target_len):
        return [np.pad(a, [(0, 0)] * (a.ndim - 1)
                       + [(0, target_len - a.shape[-1])])
                for a in arrays]

    def collate_fn(self, exs):
        """List of example dicts -> batch dict of stacked arrays.

        Variable-length examples are zero-padded on the time axis (rounded
        up to a shift multiple) and loss masks (``_sample_mask`` /
        ``_frame_mask``) are attached; the losses then average over valid
        samples/frames only (``tssep_tpu/tasks/model.py:255-307``).
        """
        time_keys = {'observation', 'vad', *self.loss.targets(lower=True)}
        lengths = [e['observation'].shape[-1] for e in exs
                   if 'observation' in e]
        ragged = len(set(lengths)) > 1
        if ragged:
            quantum = self.fe.shift * self.pad_shift_multiple
            target_len = -(-max(lengths) // quantum) * quantum
            num_frames = [self.fe.num_frames(n) for n in lengths]
            padded_frames = self.fe.num_frames(target_len)

        keys = exs[0].keys()
        ex = {}
        for k in keys:
            vals = [e[k] for e in exs]
            if isinstance(vals[0], np.ndarray):
                if ragged and k in time_keys:
                    vals = self._pad_time(vals, target_len)
                elif ragged and k == 'Vad':
                    vals = self._pad_time(vals, padded_frames)
                try:
                    ex[k] = np.stack(vals)
                except ValueError:
                    ex[k] = vals  # ragged non-time key
            else:
                ex[k] = vals

        if ragged:
            ex['num_samples'] = np.asarray(lengths)
            sm = np.zeros((len(exs), 1, target_len), dtype=np.float32)
            fm = np.zeros((len(exs), 1, padded_frames), dtype=np.float32)
            for i, (n, nf) in enumerate(zip(lengths, num_frames)):
                sm[i, 0, :n] = 1
                fm[i, 0, :nf] = 1
            ex['_sample_mask'] = sm
            ex['_frame_mask'] = fm
        if 'Vad' in ex and isinstance(ex['Vad'], list) and \
                isinstance(ex['Vad'][0], np.ndarray):
            try:
                ex['Vad'] = np.stack(ex['Vad'])
            except ValueError:
                pass
        assert len(set(ex['reference_channel'])) == 1, ex['reference_channel']
        ex['reference_channel'] = ex['reference_channel'][0]
        return ex

    def prepare_train_dataset(self, device=None, batch_size=None,
                              prefetch=True, reader=None, sort=False,
                              host_shard=False, drop_last=False):
        return self.prepare_dataset(
            self.reader.train_dataset_name, device=device, training=True,
            batch_size=batch_size, prefetch=prefetch, reader=reader,
            sort=sort, host_shard=host_shard, drop_last=drop_last)

    def prepare_validate_dataset(self, device=None, batch_size=None,
                                 prefetch=True, reader=None, sort=False,
                                 host_shard=False, drop_last=False):
        return self.prepare_dataset(
            self.reader.validate_dataset_name, device=device, training=False,
            batch_size=batch_size, prefetch=prefetch, reader=reader,
            sort=sort, host_shard=host_shard, drop_last=drop_last)

    def prepare_eval_dataset(self, device=None, batch_size=None, prefetch=True,
                             reader=None, sort=False, load_keys=None):
        if reader is None:
            reader = self.reader
        return self.prepare_dataset(
            reader.eval_dataset_name, device=device, training=False,
            review=False, batch_size=batch_size, prefetch=prefetch,
            reader=reader, sort=sort, verbose=True, load_keys=load_keys)

    # ------------------------------------------------------------------
    # Device side
    # ------------------------------------------------------------------

    def init_params(self, generator: torch.Generator):
        self.mask_estimator.init_params(generator)
        return self

    def num_params(self):
        return self.mask_estimator.num_params()

    def _tensor(self, value, dtype=torch.float32):
        return torch.as_tensor(value, dtype=dtype, device=self.device)

    def _features(self, ex: dict) -> dict:
        """``ex`` with ``Input``, the features, made from what it brings:
        ``Input`` as it is, else from ``Observation``, else from
        ``observation``'s STFT, or from its reference channel's samples
        where the feature extractor takes waveforms
        (``tssep_tpu/tasks/model.py:343-358``)."""
        ref = ex['reference_channel']
        if 'Input' in ex:
            ex['Input'] = self._tensor(ex['Input'])
            if 'Observation' in ex:
                ex['Observation'] = self._tensor(ex['Observation'],
                                                 torch.complex64)
            return ex
        if 'Observation' not in ex:
            if not hasattr(self.fe, 'stft'):
                # a waveform feature extractor (KaldiMFCC): the Kaldi-input
                # TS-VAD path (reference model.py:510-513), no estimate
                ex['Input'] = self.fe(
                    self._tensor(ex['observation'])[..., ref, :]).float()
                return ex
            ex['Observation'] = self.fe.stft(self._tensor(ex['observation']))
        else:
            ex['Observation'] = self._tensor(ex['Observation'],
                                             torch.complex64)
        ex['Input'] = self.fe.stft_to_feature(
            ex['Observation'][..., ref, :, :]).float()
        return ex

    def forward(self, ex: dict, generator: torch.Generator | None = None,
                training=False) -> ForwardOutput:
        """Masks, the enhanced STFT and the separated waveforms of one batch
        ``ex``. ``generator`` draws the random speaker order (none: the
        input's order) and, when ``training``, the dropout. Serving
        (``training=False``) records no graph and returns every output;
        training keeps the graph and makes only the estimates that the
        loss reads."""
        with contextlib.nullcontext() if training else torch.no_grad():
            ex = self.pre_net_hook(self._features(dict(ex)))
            me_out = self.mask_estimator(
                ex['Input'], self._tensor(ex['auxInput']), generator,
                training)
            out = ForwardOutput(
                mask=me_out.mask, logit=me_out.logit,
                embedding=me_out.embedding, vad_mask=me_out.vad_mask,
                vad_logit=me_out.vad_logit)
            if 'Observation' not in ex:
                if not isinstance(self.loss, loss_mod.VADSigmoidBCE):
                    raise ValueError(
                        f'a batch without Observation has no estimate to '
                        f'train {self.loss.name} on; only VADSigmoidBCE '
                        f'trains from Input alone')
                return out
            wanted = self.loss.reads if training else {'stft_estimate',
                                                       'time_estimate'}
            re_im = getattr(self.enhancer, 're_im', None)
            if 'stft_estimate' in wanted or (
                    'time_estimate' in wanted and re_im is None):
                out.stft_estimate = self.enhancer(me_out.mask, ex)
            if 'time_estimate' in wanted and 'observation' in ex:
                estimate = (out.stft_estimate if re_im is None
                            else re_im(me_out.mask, ex))
                head = self.mask_estimator.head_dtype
                if estimate is not None:
                    out.time_estimate = self.fe.istft(
                        estimate, num_samples=ex['observation'].shape[-1],
                        segment_dtype=None if head == torch.float32 else head)
            return out

    def review_loss(self, ex: dict, out: ForwardOutput):
        """The loss of a forward's output; returns (loss summed over the
        batch, per-example loss)."""
        loss_value = self.loss.from_ex_out(ex, out, self)
        return loss_value.sum(), loss_value

    def loss_fn(self, ex: dict, generator: torch.Generator | None = None,
                training=True):
        """The function the trainer differentiates: (scalar loss,
        ``{'per_example_loss': ...}``)."""
        out = self.forward(ex, generator, training=training)
        loss_sum, loss_value = self.review_loss(ex, out)
        return loss_sum, {'per_example_loss': loss_value}

    # ------------------------------------------------------------------
    # Snapshots (host side, for tensorboard)
    # ------------------------------------------------------------------
    def add_snapshots(self, ex, out: ForwardOutput, summary,
                      max_speakers=4):
        """Push audio / spectrogram-image / mask-image payloads for the
        first example of a batch into a ``ReviewSummary``
        (``tssep_tpu/tasks/model.py:404-470``; reference
        ``model.py:692-752`` and the VAD-overlay mask images of
        ``loss.py:148-169``)."""
        name = self.enhancer.name
        sr = getattr(self.reader, 'sample_rate', 16000)

        # The batch may be collated (leading batch dim) or a single raw
        # example (test_run's pre-flight feeds whatever its dataset
        # yields): detect from the mask rank, fall back to the observation
        # rank.
        if out.mask is not None:
            batched = out.mask.dim() == 5
        elif 'observation' in ex:
            batched = _host(ex['observation']).ndim == 3
        else:
            batched = True

        def first(x):  # leading batch entry, on the host
            x = _host(x)
            return x[0] if (batched and x.ndim) else x

        if out.time_estimate is not None:
            est = first(out.time_estimate)
            summary.add_audio(f'{name}_audio_est', est.reshape(
                -1, est.shape[-1])[0], sr)
        if 'observation' in ex:
            obs = first(ex['observation'])
            summary.add_audio(f'{name}_audio_observation',
                              obs.reshape(-1, obs.shape[-1])[0], sr)
        if 'Observation' in ex:
            o = first(ex['Observation'])
            summary.add_stft_image(
                f'{name}_Observation_stft', o.reshape(
                    (-1,) + o.shape[-2:])[0])
        elif 'observation' in ex and hasattr(self.fe, 'stft'):
            o = _host(self.fe.stft(torch.as_tensor(first(ex['observation']))))
            summary.add_stft_image(
                f'{name}_Observation_stft',
                o.reshape((-1,) + o.shape[-2:])[0])
        if out.stft_estimate is not None:
            e = first(out.stft_estimate)
            summary.add_stft_image(
                f'{name}_stft_estimate', e.reshape((-1,) + e.shape[-2:])[0])
        if out.mask is not None:
            mask = first(out.mask)      # (spk, nmask, T, F)
            vad = first(ex['Vad']) if 'Vad' in ex else None  # (spk, frames)
            for s in range(min(mask.shape[0], max_speakers)):
                m = mask[s].reshape((-1,) + mask.shape[-2:])[0]  # (T, F)
                if m.ndim == 1:   # 't' resolution: per-frame activity
                    m = m[:, None]
                img = m
                if vad is not None and vad.shape[-1] == m.shape[0]:
                    # VAD-target stripe composited next to the mask
                    # (reference loss.py:148-169)
                    width = max(4, m.shape[1] // 16)
                    sep = np.full((m.shape[0], 2), 0.5, m.dtype)
                    stripe = np.repeat(
                        vad[s].astype(m.dtype)[:, None], width, axis=1)
                    img = np.concatenate([m, sep, stripe], axis=1)
                summary.add_mask_image(f'mask_spk{s}', img)

    def snapshots(self, ex, out: ForwardOutput):
        """Audio/image payloads mirroring reference ``model.py:692-752``."""
        snaps = {}
        name = self.enhancer.name
        if out.time_estimate is not None:
            snaps[f'{name}_audio_est'] = _host(out.time_estimate)
        if 'observation' in ex:
            snaps[f'{name}_audio_observation'] = _host(
                ex['observation'])[..., 0, :]
        if 'Observation' in ex:
            snaps[f'{name}_Observation_stft'] = np.abs(
                _host(ex['Observation']))[..., 0, :, :]
        if out.mask is not None:
            snaps['mask'] = _host(out.mask)
        if out.stft_estimate is not None:
            snaps[f'{name}_stft_estimate'] = np.abs(_host(out.stft_estimate))
        return snaps
