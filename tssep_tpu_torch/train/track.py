"""Model instrumentation: port of ``tssep_tpu/train/track.py``.

The reference's forward-hook trackers (``padertorch.contrib.cb.track``,
``experiment.py:234-257``): a parameter table, a per-stage shape table, a
per-stage time table (CUDA events on the card, the host clock on the CPU)
and an operation count from ``torch.utils.flop_counter.FlopCounterMode``
in place of XLA's cost analysis. Written to ``log/*.txt`` by
``Experiment.train``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tssep_tpu_torch.train.checkpoint import params_to_named

__all__ = ['param_table', 'model_report', 'shape_report',
           'layer_time_report', 'cost_report']


def param_table(model) -> str:
    named = params_to_named(model)
    lines = []
    total = 0
    width = max((len(k) for k in named), default=20)
    for name, arr in named.items():
        n = int(np.prod(arr.shape))
        total += n
        lines.append(f'{name:<{width}}  {str(tuple(arr.shape)):<20} {n:>12,}')
    lines.append('-' * (width + 34))
    lines.append(f'{"total":<{width}}  {"":<20} {total:>12,}')
    return '\n'.join(lines)


def model_report(model) -> str:
    return '\n'.join([
        f'Model: {type(model).__name__}',
        f'  feature extractor: {type(model.fe).__name__}',
        f'  enhancer: {model.enhancer.name}',
        f'  loss: {model.loss.name}',
        f'  storage: {model.mask_estimator.storage_dtype}, device: '
        f'{model.device}',
        '',
        'Parameters:',
        param_table(model),
    ])


def _stages(model, example):
    """The mask estimator's stages as (name, function of the previous
    stage's output) on ``example``'s first channel, as
    ``MaskEstimator.forward`` runs them without permutation trials or
    dropout."""
    me = model.mask_estimator
    dev = model.device
    obs = torch.as_tensor(example['observation'], dtype=torch.float32,
                          device=dev)
    if obs.dim() == 2:
        obs = obs[None]
    aux = torch.as_tensor(example['auxInput'], dtype=torch.float32,
                          device=dev)
    if aux.dim() == 2:
        aux = aux[None]
    state = {'aux': aux}

    def conditioning(x):
        a = state['aux']
        if me.aux_net is not None:
            a = me.aux_net(a)
        elif me.aux_normalizer is not None:
            a = me.aux_normalizer(a)
        a = a.to(me.storage_dtype)
        x = x.to(me.storage_dtype)
        if me.combination == 'mul':
            return x[:, None] * a[:, :, None]
        return torch.cat([x[:, None].expand(-1, a.shape[1], -1, -1),
                          a[:, :, None].expand(-1, -1, x.shape[1], -1)], -1)

    stages = [('fe.stft', lambda _: model.fe.stft(obs)),
              ('fe.stft_to_feature',
               lambda o: model.fe.stft_to_feature(o[..., 0, :, :]).float())]
    if me.input_normalizer is not None:
        stages.append(('input_normalizer', me.input_normalizer))
    if me.pre_net is not None:
        stages.append(('pre_net', me.pre_net))
    stages.append((f'conditioning ({me.combination})', conditioning))
    for layer in range(me.layers):
        birnn = getattr(me.post_net, f'birnn{layer}')

        def run(h, birnn=birnn, layer=layer):
            if layer == me.layers - 1 and me.ts_vad:
                h = h.transpose(1, 2).reshape(h.shape[0], h.shape[2], 1,
                                              -1).transpose(1, 2)
            h = birnn(h)
            return torch.tanh(h) if layer < me.layers - 1 else h
        stages.append((f'post_net.birnn{layer}', run))
    lin = getattr(me.post_net, f'linear{me.layers - 1}')
    stages.append(('head (linear+sigmoid)', lambda h: torch.sigmoid(
        torch.nn.functional.linear(h, lin.weight.to(h.dtype),
                                   lin.bias.to(h.dtype)))))
    return stages


def shape_report(model, example) -> str:
    """Per-stage output shapes of the mask estimator on ``example`` (the
    reference's ShapeTracker)."""
    rows = []
    with torch.no_grad():
        x = None
        for name, fn in _stages(model, example):
            x = fn(x)
            rows.append((name, tuple(x.shape)))
    width = max(len(n) for n, _ in rows)
    return '\n'.join(f'{n:<{width}}  {s}' for n, s in rows)


def layer_time_report(model, example, iters=2) -> str:
    """Per-stage time of the mask estimator on ``example`` (the reference
    TimeTracker, ``net.py:453-483``): each stage timed on its real input
    after one warm call, by CUDA events on the card and the host clock on
    the CPU. The sum approximates, not equals, a forward."""
    rows = []
    cuda = model.device.type == 'cuda'
    with torch.no_grad():
        x = None
        for name, fn in _stages(model, example):
            out = fn(x)
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    fn(x)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / iters
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(x)
                ms = 1e3 * (time.perf_counter() - t0) / iters
            rows.append((name, tuple(out.shape), ms))
            x = out
    width = max(len(n) for n, _, _ in rows)
    total = sum(ms for _, _, ms in rows)
    lines = [f'{n:<{width}}  {str(s):<28} {ms:9.2f} ms' for n, s, ms in rows]
    lines.append('-' * (width + 42))
    lines.append(f'{"total (stage sum)":<{width}}  {"":<28} {total:9.2f} ms')
    return '\n'.join(lines)


def cost_report(model, example) -> str:
    """Operations of one validation loss (``Model.loss_fn``, no graph) by
    ``FlopCounterMode``. It counts PyTorch operators: the hand-written
    kernels that the wrappers launch on the card are not among them (on
    the CPU their plain versions are)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False, depth=2)
    with torch.no_grad(), counter:
        model.loss_fn(example, None, training=False)
    lines = [f'FlopCounterMode: {counter.get_total_flops():,} operations '
             f'(PyTorch operators only; kernels launched by the wrappers on '
             f'the card are not counted)']
    for module, counts in counter.get_flop_counts().items():
        total = sum(counts.values())
        if total:
            lines.append(f'  {module}: {total:,}')
    return '\n'.join(lines)
