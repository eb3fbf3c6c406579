"""Speaker-conditioned mask estimator: port of ``tssep_tpu/nn/estimator.py``.

The forward of ``MaskEstimator``, for serving and for training: shared
``pre_net`` RNNP over the mixture -> speaker-embedding conditioning ('mul'
elementwise or 'cat' concatenation) -> per-speaker BLSTM stack with the
speakers folded into the batch -> optional TS-VAD cross-speaker stacking
before the last BLSTM -> linear head -> per-speaker (mask, time, frequency)
logits, averaged over ``num_averaged_permutations`` cyclic speaker orders
-> sigmoid, with the optional ``explicit_vad`` gate. In training, dropout
between the post-net layers draws from the caller's generator.

``cond_fuse`` (JAX ``TSSEP_PALLAS_CONDFUSE``) runs the 'mul' conditioning
and the first post-net layer as one conditioned layer
(``RNNP.forward_conditioned``), where JAX's condition for it holds; else
the conditioned (B, S, T, F) tensor is materialized. ``fullfuse`` (JAX
``TSSEP_PALLAS_FULLFUSE``), ``spill`` (JAX ``TSSEP_PALLAS_SPILL``) and
``bidi`` (JAX ``TSSEP_PALLAS_BIDI``) pick the BLSTM kernels of every RNNP
(``nn/rnnp.py`` ``blstm_apply``); ``spill`` and ``bidi`` leave the
conditioned layer as it is, as in JAX.

The speaker embeddings go through an ``aux_net`` (``LinearAux``, or the
SpeakerBeam-style ``AuxNet`` with its masked mean over the aux frames) or an
``aux_normalizer``, and the features through an ``input_normalizer`` before
``pre_net`` (``nn/norm.py``), all in float32.

From ``pre_net`` on, activations are kept in the storage dtype; the head and
its outputs are in ``head_dtype``: float32 by default, bfloat16 as JAX's
``TSSEP_HEAD_BF16=1`` (``tssep_tpu/nn/estimator.py:124-131``) casts them, the
mode the flagship's benchmark and the simulated recipe run in.
"""

from __future__ import annotations

import dataclasses
import typing

import torch
from torch import nn

from tssep_tpu_torch.dist.mesh import batch_rand
from tssep_tpu_torch.nn.init import linear_init_
from tssep_tpu_torch.nn.norm import norm_from_config
from tssep_tpu_torch.nn.rnnp import RNNP, inverted_dropout
from tssep_tpu_torch.utils.device import resolve_device
from tssep_tpu_torch.utils.factory import factory_name

__all__ = ['MaskEstimator', 'Output', 'LinearAux', 'AuxNet',
           'aux_net_from_config']


@dataclasses.dataclass
class Output:
    mask: typing.Any
    logit: typing.Any
    embedding: typing.Any = None
    vad_mask: typing.Any = None
    vad_logit: typing.Any = None


def _permutation_trial_indices(speakers: int, trials: int, device):
    """Cyclic-shift speaker index expansion and its inverse (JAX
    ``_permutation_trial_indices``, ``tssep_tpu/nn/estimator.py:134``)."""
    s = torch.arange(speakers, device=device)
    idx = ((s[:, None] + s[None, :]) % speakers)[:trials].reshape(-1)
    return idx, torch.argsort(idx, stable=True)


class LinearAux(nn.Module):
    """Linear projection of the aux embeddings (``tssep_tpu/nn/estimator.py:
    53``); its parameters are ``net.weight`` and ``net.bias``."""

    def __init__(self, idim, odim, bias=True, *, device='cuda'):
        super().__init__()
        self.idim, self.odim = idim, odim
        self.net = nn.Linear(idim, odim, bias=bias,
                             device=resolve_device(device))

    def init_params(self, generator: torch.Generator):
        linear_init_(self.net, generator)

    def forward(self, aux, lengths=None):
        return self.net(aux)


class AuxNet(nn.Module):
    """SpeakerBeam-style aux network (``tssep_tpu/nn/estimator.py:72``): an
    optional normalizer, three linear layers with ReLU between them, and the
    mean over the aux frames. aux: (..., spk, aux_frames, idim) ->
    (..., spk, odim); ``lengths`` (..., spk) leaves the padded aux frames out
    of the mean."""

    @classmethod
    def finalize_dogmatic_config(cls, config):
        if config.get('odim') is None:
            config['odim'] = config['idim']

    def __init__(self, idim, odim=None, normalizer=None, *, device='cuda'):
        super().__init__()
        if odim is None:
            odim = idim
        elif odim != idim:
            raise NotImplementedError(f'AuxNet odim {odim} != idim {idim}')
        device = resolve_device(device)
        self.idim, self.odim = idim, odim
        self.normalizer = norm_from_config(normalizer)
        for i in range(3):
            self.add_module(f'linear{i}', nn.Linear(idim, idim,
                                                    device=device))

    def init_params(self, generator: torch.Generator):
        for i in range(3):
            linear_init_(getattr(self, f'linear{i}'), generator)

    def forward(self, aux, lengths=None):
        h = aux if self.normalizer is None else self.normalizer(aux)
        for i in range(3):
            h = getattr(self, f'linear{i}')(h)
            if i < 2:
                h = torch.relu(h)
        if lengths is None:
            return h.mean(dim=-2)
        lengths = torch.as_tensor(lengths, device=h.device)
        mask = (torch.arange(h.shape[-2], device=h.device)
                < lengths[..., None]).to(h.dtype)
        return (h * mask[..., None]).sum(dim=-2) / lengths[..., None].to(
            h.dtype)


_AUX_NETS = {'LinearAux': LinearAux, 'AuxNet': AuxNet}


def aux_net_from_config(config, *, device='cuda'):
    """An aux net from the JAX configuration's form (``{'factory': name,
    **kwargs}``, the class's name or dotted path); None passes through."""
    if config is None:
        return None
    config = dict(config)
    name = factory_name(config.pop('factory'))
    if name not in _AUX_NETS:
        raise ValueError(f'unknown aux net {name!r}')
    return _AUX_NETS[name](**config, device=device)


def _gather_speakers(x, perm):
    """``x`` (B, S, ...) in the speaker order ``perm`` (B, S)."""
    index = perm.reshape(perm.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, index.expand(x.shape))


class MaskEstimator(nn.Module):
    """See the module docstring. Arguments as ``tssep_tpu``'s
    ``MaskEstimator``; ``aux_net``, ``input_normalizer`` and
    ``aux_normalizer`` take a module or its JAX configuration's form."""

    @classmethod
    def finalize_dogmatic_config(cls, config):
        """The JAX class's rules (``tssep_tpu/nn/estimator.py:146-153``):
        without an aux net an i-vector size of 100; with one its ``idim``
        the estimator's ``odim`` and, for 'cat', the aux net's ``odim`` as
        the embedding size. Values the configuration sets win."""
        if config.get('aux_net') is None:
            config['aux_net_output_size'] = 100
        else:
            config['aux_net']['idim'] = config.get('odim') or config['idim']
            if (config.get('combination', 'cat') == 'cat'
                    and 'odim' in config['aux_net']):
                config['aux_net_output_size'] = config['aux_net']['odim']

    def __init__(self, *, idim=80, odim=None, layers=3, units=300, projs=320,
                 dropout=0, nmask=1, pre_net='RNNP', aux_net=None,
                 aux_net_output_size=None, combination='cat', ts_vad=False,
                 output_resolution='tf', random_speaker_order=True,
                 num_averaged_permutations=1, input_normalizer=None,
                 aux_normalizer=None, explicit_vad=False,
                 storage_dtype=torch.bfloat16, head_dtype=torch.float32,
                 cond_fuse=False, fullfuse=True, spill=False, bidi=True,
                 device='cuda'):
        super().__init__()
        device = resolve_device(device)
        if isinstance(aux_net, dict):
            aux_net = aux_net_from_config(aux_net, device=device)
        if aux_net is not None and aux_normalizer is not None:
            raise ValueError('aux_net and aux_normalizer exclude each other')
        self.aux_net = aux_net
        self.input_normalizer = norm_from_config(input_normalizer)
        self.aux_normalizer = norm_from_config(aux_normalizer)
        if num_averaged_permutations < 1 or (
                not ts_vad and num_averaged_permutations != 1):
            raise ValueError(f'num_averaged_permutations='
                             f'{num_averaged_permutations} with ts_vad='
                             f'{ts_vad}: more than one needs ts_vad')
        if output_resolution == 't' and explicit_vad:
            raise ValueError("explicit_vad needs output_resolution='tf'")
        if ts_vad and not 2 < ts_vad < 20:
            raise ValueError(f'ts_vad={ts_vad}')
        if odim is None:
            odim = idim
        self.idim, self.odim, self.layers = idim, odim, layers
        self.units, self.projs, self.nmask = units, projs, nmask
        self.combination = combination
        self.ts_vad = ts_vad
        self.output_resolution = output_resolution
        self.random_speaker_order = random_speaker_order
        self.explicit_vad = explicit_vad
        self.aux_net_output_size = aux_net_output_size
        self.storage_dtype = storage_dtype
        self.head_dtype = head_dtype
        self.dropout = dropout
        self.ts_factor = int(ts_vad) if ts_vad else 1
        self.num_averaged_permutations = num_averaged_permutations
        self.cond_fuse = cond_fuse

        rnnp = dict(dropout=dropout, storage_dtype=storage_dtype,
                    fullfuse=fullfuse, spill=spill, bidi=bidi, device=device)
        if pre_net == 'RNNP':
            self.pre_net = RNNP(idim, elayers=1, cdim=units, hdim=odim, **rnnp)
        elif pre_net in (None, False):
            self.pre_net = None
        else:
            raise ValueError(pre_net)

        if combination == 'cat':
            if aux_net_output_size is None:
                raise ValueError("combination='cat' needs aux_net_output_size")
            first_birnn_idim = odim + aux_net_output_size
        elif combination == 'mul':
            if aux_net_output_size not in (None, odim):
                raise ValueError(
                    f"combination='mul' needs aux embeddings of size odim="
                    f"{odim}, got aux_net_output_size={aux_net_output_size}")
            first_birnn_idim = odim
        else:
            raise NotImplementedError(combination)

        if output_resolution == 'tf':
            self.final_out_features = ((odim + int(explicit_vad)) * nmask
                                       * self.ts_factor)
        elif output_resolution == 't':
            self.final_out_features = nmask * self.ts_factor
        else:
            raise ValueError(output_resolution)

        self.post_net = nn.Module()
        for l in range(layers):
            in_l = first_birnn_idim if l == 0 else projs
            if l == layers - 1 and ts_vad:
                in_l *= self.ts_factor
            self.post_net.add_module(
                f'birnn{l}', RNNP(in_l, elayers=1, cdim=units, hdim=projs,
                                  **rnnp))
        self.post_net.add_module(
            f'linear{layers - 1}',
            nn.Linear(projs, self.final_out_features, device=device))

    def init_params(self, generator: torch.Generator):
        if self.pre_net is not None:
            self.pre_net.init_params(generator)
        for l in range(self.layers):
            getattr(self.post_net, f'birnn{l}').init_params(generator)
        linear_init_(getattr(self.post_net, f'linear{self.layers - 1}'),
                     generator)
        if self.aux_net is not None:
            self.aux_net.init_params(generator)

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def conditioned_first_layer(self):
        """Whether ``cond_fuse`` runs the conditioning and ``birnn0`` as one
        conditioned layer: JAX's condition (``tssep_tpu/nn/estimator.py:
        367-372``), 'mul', not a single layer that stacks the speakers
        first, and a one-layer ``birnn0`` (always bidirectional here)."""
        return (self.cond_fuse and self.combination == 'mul'
                and not (self.layers == 1 and self.ts_vad)
                and self.post_net.birnn0.elayers == 1)

    def reshape_head(self, logit, S, T):
        """Post-net linear output -> (B', S, nmask, T, Fh) in
        ``head_dtype``."""
        logit = logit.to(self.head_dtype)
        B, M = logit.shape[0], self.nmask
        if self.output_resolution == 'tf':
            Fh = self.odim + int(self.explicit_vad)
            if self.ts_vad:                       # (B', 1, T, S*M*Fh)
                return logit.reshape(B, T, S, M, Fh).permute(0, 2, 3, 1, 4)
            return logit.reshape(B, S, T, M, Fh).permute(0, 1, 3, 2, 4)
        if self.ts_vad:
            logit = logit.reshape(B, T, S, M).permute(0, 2, 3, 1)
        else:
            logit = logit.reshape(B, S, T, M).permute(0, 1, 3, 2)
        return logit[..., None].expand(logit.shape + (self.odim,))

    def forward(self, xs, aux, generator: torch.Generator | None = None,
                training=False, aux_lengths=None) -> Output:
        """xs: (T, F) or (B, T, F); aux: (S, A) or (B, S, A), with an
        aux-frame axis before A where ``aux_net`` is set (``aux_lengths``
        (B?, S) its valid frames). Returns masks (B?, S, nmask, T, odim).
        With a ``generator`` and ``random_speaker_order``, the speakers run
        in a random order drawn from it, and the outputs come back in the
        input's order; when ``training``, the generator also draws the
        dropout between the post-net layers (``dropout > 0``)."""
        batched = xs.dim() == 3
        if not batched:
            xs, aux = xs[None], aux[None]
            if aux_lengths is not None:
                aux_lengths = torch.as_tensor(aux_lengths)[None]
        B, T, _ = xs.shape
        S = aux.shape[1]

        perm = None
        if self.random_speaker_order and generator is not None:
            perm = batch_rand(generator, (B, S)).argsort(-1).to(aux.device)
            aux = _gather_speakers(aux, perm)
            if aux_lengths is not None:
                aux_lengths = _gather_speakers(
                    torch.as_tensor(aux_lengths, device=aux.device), perm)

        if self.aux_net is not None:
            aux = self.aux_net(aux, aux_lengths)
        elif self.aux_normalizer is not None:
            aux = self.aux_normalizer(aux)
        aux = aux.to(xs.dtype)

        if self.input_normalizer is not None:
            xs = self.input_normalizer(xs)
        if self.pre_net is not None:
            xs = self.pre_net(xs, generator, training)
        xs = xs.to(self.storage_dtype)
        aux = aux.to(self.storage_dtype)

        trials = self.num_averaged_permutations
        if trials > 1:
            idx, revert_idx = _permutation_trial_indices(S, trials,
                                                         xs.device)
        first_layer = 0
        if self.conditioned_first_layer():
            # the trials expand aux, which is expanding the product
            if trials > 1:
                aux_c = aux[:, idx].reshape(B * trials, S, aux.shape[-1])
                xs_c = xs[:, None].expand(B, trials, *xs.shape[1:]).reshape(
                    B * trials, *xs.shape[1:])
            else:
                xs_c, aux_c = xs, aux
            h = self.post_net.birnn0.forward_conditioned(xs_c, aux_c)
            if self.layers > 1:
                if training:
                    h = inverted_dropout(h, self.dropout, generator)
                h = torch.tanh(h)
            first_layer = 1
        else:
            if self.combination == 'mul':
                h = xs[:, None, :, :] * aux[:, :, None, :]
            else:
                h = torch.cat(
                    [xs[:, None].expand(B, S, T, xs.shape[-1]),
                     aux[:, :, None, :].expand(B, S, T, aux.shape[-1])],
                    dim=-1)                       # (B, S, T, F')
            if trials > 1:                        # (B trials, S, T, F')
                h = h[:, idx].reshape(B * trials, S, *h.shape[2:])

        for l in range(first_layer, self.layers):
            if l == self.layers - 1 and self.ts_vad:
                # cross-speaker stacking: (B, S, T, F) -> (B, 1, T, S*F)
                h = h.transpose(1, 2).reshape(h.shape[0], T, 1,
                                              -1).transpose(1, 2)
            h = getattr(self.post_net, f'birnn{l}')(h, generator, training)
            if l < self.layers - 1:
                if training:
                    h = inverted_dropout(h, self.dropout, generator)
                h = torch.tanh(h)

        lin = getattr(self.post_net, f'linear{self.layers - 1}')
        logit = nn.functional.linear(h, lin.weight.to(h.dtype),
                                     lin.bias.to(h.dtype))
        logit = self.reshape_head(logit, S, T)

        if trials > 1:                            # average the trials
            logit = logit.reshape(B, trials * S, *logit.shape[2:])
            logit = logit[:, revert_idx].reshape(
                B, S, trials, *logit.shape[2:]).mean(dim=2)

        if perm is not None:
            logit = _gather_speakers(logit, perm.argsort(-1))

        embedding = aux[:, :, None, :]
        if self.explicit_vad:
            mask = torch.sigmoid(logit)
            vad_mask = mask[..., 0]
            out = Output(mask=mask[..., 1:] * vad_mask[..., None], logit=None,
                         vad_mask=vad_mask, vad_logit=logit[..., 0],
                         embedding=embedding)
        else:
            out = Output(mask=torch.sigmoid(logit), logit=logit,
                         embedding=embedding)
        if not batched:
            out = Output(**{f.name: (None if getattr(out, f.name) is None
                                     else getattr(out, f.name)[0])
                            for f in dataclasses.fields(out)})
        return out


#: Reference-compatible alias (its configs name the class MaskEstimator_v2).
MaskEstimator_v2 = MaskEstimator
