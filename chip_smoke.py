"""Drive the PyTorch port (``tssep_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each of which must pass:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: the CUDA kernels, one ``nvcc`` per source started together, with
   ``-Xptxas -v``'s registers and shared memory;
3. kernels: each kernel against its plain PyTorch version on the card, in
   float32 and in bfloat16 storage, with max error, kernel time, plain time
   and bound: the forward kernels at a ragged small shape, at the shapes of
   a served request (batch 16) and at the flagship training shapes (batch
   256); the backward kernels at a ragged shape and at the training shapes
   of batch 16 and of batch 256;
4. serving: the flagship TS-SEP model (``bench.py:98-106``, random weights
   from a seed) answers 3 requests of batch 16 through the kernels, which the
   launch counters prove, and its masks and waveforms agree with the same
   model run through the plain versions;
5. training: the same model trains 3 steps at batch 16 on batches from the
   port's on-device simulator (``Trainer.train``, LogMAE, clipped Adam),
   through all four kernels, with finite losses; then one step's loss and
   every parameter's gradient agree with those through the plain versions,
   in bfloat16 and in float32 storage.

The last two lines of standard output are the kernels' JSON line and the
device's JSON line. Without CUDA it exits with code 1 and prints no result.
"""

from __future__ import annotations

import sys

sys.dont_write_bytecode = True        # write nothing into the checkout

import contextlib  # noqa: E402
import json        # noqa: E402
import math        # noqa: E402
import subprocess  # noqa: E402
import time        # noqa: E402
from unittest import mock  # noqa: E402

import torch  # noqa: E402

from tssep_tpu_torch.data.device_sim import (  # noqa: E402
    DeviceMeetingSimulator, DeviceSimDataset)
from tssep_tpu_torch.kernels import _build  # noqa: E402
from tssep_tpu_torch.kernels import blstm as kb  # noqa: E402
from tssep_tpu_torch.nn import rnnp  # noqa: E402
from tssep_tpu_torch.tasks.model import Model  # noqa: E402
from tssep_tpu_torch.train.optimizer import Adam  # noqa: E402
from tssep_tpu_torch.train.trainer import Trainer  # noqa: E402

FLAGSHIP = {
    'fe': {'size': 1024, 'shift': 256, 'window': 'hann'},
    'reader': {'aux_size': 513},
    'mask_estimator': {
        'units': 300, 'projs': 320, 'combination': 'mul', 'ts_vad': 8,
        'aux_net_output_size': 513, 'num_averaged_permutations': 1,
        'output_resolution': 'tf',
    },
}
SAMPLES, FRAMES, BINS, SPEAKERS, HIDDEN = 80_000, 316, 513, 8, 300
SERVE_BATCH, REQUESTS = 16, 3
TRAIN_BATCH, TRAIN_STEPS = 16, 3

BF16, F32 = torch.bfloat16, torch.float32
#: Kernel against plain version, max abs error of h and c (|h| < 1). float32:
#: the same f32 sums in another order, through 316 steps. bfloat16: h is
#: rounded to bf16 before each recurrent product, so a sum order that differs
#: in the last f32 bit flips a rounding now and then; each flip is one bf16
#: ulp (2^-8 below 1) and echoes through the following steps.
KERNEL_ATOL = {F32: 1e-4, BF16: 3e-2}
#: Served masks (in [0, 1]) and waveforms (relative to their peak), kernels
#: against plain versions, through four BLSTM layers and three projections.
SERVE_ATOL = {F32: 1e-4, BF16: 5e-2}
#: Backward kernel against plain version: each output's max abs error over
#: that output's max abs value. float32: the same f32 products summed in
#: another order (the weight sums run over up to 647k rows). bfloat16: both
#: recompute the gates from the same bf16 h and c, so the gate gradients
#: differ at the f32 level only, but dx (per direction) and dxg are rounded
#: to bf16, where such a difference flips a rounding now and then: one bf16
#: ulp, 2^-8 of the value.
BWD_RTOL = {F32: 1e-4, BF16: 1e-2}
#: One training step, kernels against plain versions: the loss (abs) and
#: each parameter's gradient (max abs error over max abs value). float32:
#: f32 sums in another order through the forward, the ISTFT and the
#: backward. bfloat16: the forward's h is rounded to bf16 before each
#: recurrent product, so a flipped rounding there (one bf16 ulp) echoes
#: through the following steps and into every gradient downstream.
TRAIN_TOL = {F32: 1e-3, BF16: 5e-2}

#: H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores, f32 outside
#: the tensor cores, and HBM3.
PEAK_FLOPS = {BF16: 989e12, F32: 67e12}
PEAK_BYTES = 3.35e12

SOURCES = {
    'blstm_fullfused_fwd': ('tssep_tpu_torch/kernels/csrc/'
                            'blstm_fullfused_fwd.cu',
                            'tssep_tpu/kernels/blstm.py:797'),
    'blstm_bidi_fwd': ('tssep_tpu_torch/kernels/csrc/blstm_bidi_fwd.cu',
                       'tssep_tpu/kernels/blstm.py:374'),
    'blstm_fullfused_bwd': ('tssep_tpu_torch/kernels/csrc/'
                            'blstm_fullfused_bwd.cu',
                            'tssep_tpu/kernels/blstm.py:861'),
    'blstm_bidi_bwd': ('tssep_tpu_torch/kernels/csrc/blstm_bidi_bwd.cu',
                       'tssep_tpu/kernels/blstm.py:424'),
}
KERNELS = tuple(SOURCES)
#: (label, B, T, F, H) of the fully fused kernel's calls and (label, B, T, H)
#: of the bidi kernel's. The 'serve' rows are one request of batch 16, the
#: others the flagship training shapes at batch 256.
FULLFUSED_CASES = [('ragged', 13, 23, 12, 16),
                   ('serve pre_net', 16, FRAMES, BINS, HIDDEN),
                   ('serve birnn0', 16 * SPEAKERS, FRAMES, BINS, HIDDEN),
                   ('serve birnn1', 16 * SPEAKERS, FRAMES, 320, HIDDEN),
                   ('pre_net', 256, FRAMES, BINS, HIDDEN),
                   ('birnn0', 256 * SPEAKERS, FRAMES, BINS, HIDDEN),
                   ('birnn1', 256 * SPEAKERS, FRAMES, 320, HIDDEN)]
BIDI_CASES = [('ragged', 13, 23, 16),
              ('serve birnn2', 16, FRAMES, HIDDEN),
              ('birnn2', 256, FRAMES, HIDDEN)]
#: The backward kernels' calls: 'train' rows are one training step at
#: batch 16, the others the bench's batch 256.
FULLFUSED_BWD_CASES = [('ragged', 13, 23, 12, 16),
                       ('train pre_net', 16, FRAMES, BINS, HIDDEN),
                       ('train birnn0', 16 * SPEAKERS, FRAMES, BINS, HIDDEN),
                       ('train birnn1', 16 * SPEAKERS, FRAMES, 320, HIDDEN),
                       ('pre_net', 256, FRAMES, BINS, HIDDEN),
                       ('birnn0', 256 * SPEAKERS, FRAMES, BINS, HIDDEN),
                       ('birnn1', 256 * SPEAKERS, FRAMES, 320, HIDDEN)]
BIDI_BWD_CASES = [('ragged', 13, 23, 16),
                  ('train birnn2', 16, FRAMES, HIDDEN),
                  ('birnn2', 256, FRAMES, HIDDEN)]


def log(*args):
    print(*args, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f'check failed: {what}')


def cuda_ms(fn, reps=3):
    """Mean time of ``fn`` over ``reps`` runs by CUDA events, after one
    warm-up run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes, dtype):
    """Least time in ms: operations over the peak for the storage type, or
    bytes (each input read once, each output written once) over HBM."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes')


def phase_device():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f'card: {out}')
    check(torch.cuda.device_count() >= 1, 'a CUDA device')


def phase_build():
    result = _build.build()
    log(f'build: {len(_build._sources())} nvcc calls side by side and a link, '
        f'{result.seconds:.1f} s -> {result.path.name}')
    for line in result.log.splitlines():
        if line.strip():
            log(f'  {line.strip()}')
    _build.library()


def _uniform(gen, shape, bound_, dtype):
    draw = torch.rand(shape, generator=gen, device='cuda')
    return ((2 * draw - 1) * bound_).to(dtype)


def _max_err(got, want):
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def _case(name, dtype, run, run_plain, outputs, plain_outputs, flops,
          nbytes, library=None):
    err = _max_err(outputs, plain_outputs)
    check(err <= KERNEL_ATOL[dtype],
          f'{name} max abs error {err:.3g} > {KERNEL_ATOL[dtype]}')
    ms = cuda_ms(run)
    plain_ms = cuda_ms(run_plain, reps=1)
    library_ms = None
    if library is not None:
        try:
            library_ms = cuda_ms(library)
        except RuntimeError as exc:   # a yardstick only: record its absence
            log(f'{name}: library call refused: {exc}')
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    return {'name': name, 'dtype': str(dtype).split('.')[-1],
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': library_ms}


def fullfused_case(label, B, T, F, H, dtype, gen):
    size = torch.finfo(dtype).bits // 8
    x = torch.randn(B, T, F, generator=gen, device='cuda').to(dtype)
    b = 1 / H ** 0.5
    w_ih_t = _uniform(gen, (2, F, 4 * H), b, dtype)
    w_hh_t = _uniform(gen, (2, H, 4 * H), b, dtype)
    bias = _uniform(gen, (2, 4 * H), 2 * b, F32)
    got = kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias, with_cell=True)
    want = kb.blstm_fullfused_fwd_plain(x, w_ih_t, w_hh_t, bias,
                                        with_cell=True)
    lstm = torch.nn.LSTM(F, H, bidirectional=True, batch_first=True,
                         device='cuda', dtype=dtype)
    lstm.flatten_parameters()
    return _case(
        f'blstm_fullfused_fwd {label} B={B} T={T} F={F} H={H}', dtype,
        lambda: kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias),
        lambda: kb.blstm_fullfused_fwd_plain(x, w_ih_t, w_hh_t, bias),
        got, want, flops=2 * B * T * 2 * (F + H) * 4 * H,
        nbytes=size * (B * T * F + 2 * (F + H) * 4 * H + B * T * 2 * H)
        + 4 * 2 * 4 * H,
        library=lambda: lstm(x))


def bidi_case(label, B, T, H, dtype, gen):
    size = torch.finfo(dtype).bits // 8
    xg = torch.randn(B, T, 8 * H, generator=gen, device='cuda').to(dtype)
    w_hh_t = _uniform(gen, (2, H, 4 * H), 1 / H ** 0.5, dtype)
    got = kb.blstm_bidi_fwd(xg, w_hh_t, with_cell=True)
    want = kb.blstm_bidi_fwd_plain(xg, w_hh_t, with_cell=True)
    return _case(
        f'blstm_bidi_fwd {label} B={B} T={T} H={H}', dtype,
        lambda: kb.blstm_bidi_fwd(xg, w_hh_t),
        lambda: kb.blstm_bidi_fwd_plain(xg, w_hh_t),
        got, want, flops=2 * B * T * 2 * H * 4 * H,
        nbytes=size * (B * T * 8 * H + 2 * H * 4 * H + B * T * 2 * H))


def cuda_ms_once(fn):
    """Time of one run of ``fn`` by CUDA events, and its result."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def bwd_bound(rec_flops, grad_flops, nbytes, dtype):
    """Least time in ms of a backward: the gate recompute's operations run
    on storage-type operands, the gradient products on float32 ones (as in
    the TPU backward), each over its peak; or the bytes over HBM."""
    t_ops = rec_flops / PEAK_FLOPS[dtype] + grad_flops / PEAK_FLOPS[F32]
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes')


def _bwd_case(name, dtype, run, run_plain, out_names, bound_, library=None):
    """Kernel against plain version, each output's error over its peak;
    the plain version is timed once, by the run that gives the reference.
    ``library`` makes the yardstick's call."""
    plain_ms, want = cuda_ms_once(run_plain)
    got = run()
    errs = {}
    for label, g, w in zip(out_names, got, want):
        peak = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        errs[label] = {'max_abs_err': err, 'peak': peak,
                       'rel': err / peak if peak else err}
    rel = max(e['rel'] for e in errs.values())
    check(rel <= BWD_RTOL[dtype],
          f'{name} max error over peak {rel:.3g} > {BWD_RTOL[dtype]}')
    del got, want
    ms = cuda_ms(run)
    library_ms = None
    if library is not None:
        try:
            library_ms = cuda_ms(library())
        except RuntimeError as exc:   # a yardstick only: record its absence
            log(f'{name}: library call refused: {exc}')
    bound_ms, bound_by = bound_
    return {'name': name, 'dtype': str(dtype).split('.')[-1],
            'max_abs_err': max(e['max_abs_err'] for e in errs.values()),
            'max_rel_err': rel, 'errors': errs, 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': library_ms}


def fullfused_bwd_case(label, B, T, F, H, dtype, gen):
    size = torch.finfo(dtype).bits // 8
    x = torch.randn(B, T, F, generator=gen, device='cuda').to(dtype)
    b = 1 / H ** 0.5
    w_ih_t = _uniform(gen, (2, F, 4 * H), b, dtype)
    w_hh_t = _uniform(gen, (2, H, 4 * H), b, dtype)
    bias = _uniform(gen, (2, 4 * H), 2 * b, F32)
    h, c = kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias, with_cell=True)
    dh = (0.1 * torch.randn(B, T, 2 * H, generator=gen, device='cuda')).to(
        dtype)
    args = (x, w_ih_t, w_hh_t, bias, h, c, dh)
    def library():
        """Yardstick: cuDNN's bidirectional LSTM backward at the same
        shapes, from a kept graph."""
        lstm = torch.nn.LSTM(F, H, bidirectional=True, batch_first=True,
                             device='cuda', dtype=dtype)
        lstm.flatten_parameters()
        x_leaf = x.detach().requires_grad_()
        out, _ = lstm(x_leaf)
        inputs = [x_leaf, *lstm.parameters()]
        return lambda: torch.autograd.grad(out, inputs, dh, retain_graph=True)

    rows = B * T
    # operations: gate recompute 2 rows 2 dirs (F + H) 4H on storage
    # operands; dh (4H H), weight and bias sums ((F + H + 1) 4H) and dx
    # (4H F) on f32 ones. bytes: x, h, c, dh and the weights read once, dx
    # and the weight gradients written once (f32).
    rec = 2 * rows * 2 * (F + H) * 4 * H
    grad = 2 * rows * 2 * (4 * H * H + (F + H + 1) * 4 * H + 4 * H * F)
    nbytes = (size * (rows * F + 3 * rows * 2 * H + 2 * (F + H) * 4 * H)
              + 4 * (2 * 4 * H + rows * F + 2 * (F + H + 1) * 4 * H))
    return _bwd_case(
        f'blstm_fullfused_bwd {label} B={B} T={T} F={F} H={H}', dtype,
        lambda: kb.blstm_fullfused_bwd(*args),
        lambda: kb.blstm_fullfused_bwd_plain(*args),
        ('dx', 'dw_ih', 'dw_hh', 'db'), bwd_bound(rec, grad, nbytes, dtype),
        library=library)


def bidi_bwd_case(label, B, T, H, dtype, gen):
    size = torch.finfo(dtype).bits // 8
    xg = torch.randn(B, T, 8 * H, generator=gen, device='cuda').to(dtype)
    w_hh_t = _uniform(gen, (2, H, 4 * H), 1 / H ** 0.5, dtype)
    h, c = kb.blstm_bidi_fwd(xg, w_hh_t, with_cell=True)
    dh = 0.1 * torch.randn(B, T, 2 * H, generator=gen, device='cuda')
    args = (xg, w_hh_t, h, c, dh)
    rows = B * T
    # operations: gate recompute 2 rows 2 dirs H 4H on storage operands;
    # dh (4H H) and dW_hh (H 4H) on f32 ones. bytes: xg, h, c, w_hh, dh
    # (f32) read once, dxg and dW_hh (f32) written once.
    rec = 2 * rows * 2 * H * 4 * H
    grad = 2 * rows * 2 * 2 * 4 * H * H
    nbytes = (size * (2 * rows * 8 * H + 2 * rows * 2 * H + 2 * H * 4 * H)
              + 4 * (rows * 2 * H + 2 * H * 4 * H))
    return _bwd_case(
        f'blstm_bidi_bwd {label} B={B} T={T} H={H}', dtype,
        lambda: kb.blstm_bidi_bwd(*args),
        lambda: kb.blstm_bidi_bwd_plain(*args),
        ('dxg', 'dw_hh'), bwd_bound(rec, grad, nbytes, dtype))


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)
    rows = {name: [] for name in KERNELS}
    plan = [('blstm_fullfused_fwd', fullfused_case, FULLFUSED_CASES),
            ('blstm_bidi_fwd', bidi_case, BIDI_CASES),
            ('blstm_fullfused_bwd', fullfused_bwd_case, FULLFUSED_BWD_CASES),
            ('blstm_bidi_bwd', bidi_bwd_case, BIDI_BWD_CASES)]
    for dtype in (F32, BF16):
        for name, case_fn, cases in plan:
            for case in cases:
                # graphs only for the backward cases' cuDNN yardstick
                with torch.set_grad_enabled(name.endswith('_bwd')):
                    rows[name].append(case_fn(*case, dtype, gen))
                log(json.dumps(rows[name][-1]))
                torch.cuda.empty_cache()
    return rows


def make_request(gen, batch):
    """One request in ``DeviceMeetingSimulator.generate``'s layout."""
    return {
        'observation': 0.1 * torch.randn(batch, 1, SAMPLES, generator=gen,
                                         device='cuda'),
        'auxInput': torch.rand(batch, SPEAKERS, BINS, generator=gen,
                               device='cuda'),
        'reference_channel': 0,
    }


def _plain_versions():
    """Routes ``nn/rnnp.py``'s kernel calls to the plain versions."""
    return mock.patch.multiple(
        rnnp, **{name: getattr(kb, f'{name}_plain') for name in KERNELS})


def _reset_launches():
    for name in KERNELS:
        getattr(kb, name).launches = 0


def _launches():
    return {name: getattr(kb, name).launches for name in KERNELS}


def _plain_forward(model, ex):
    with _plain_versions():
        return model(ex)


def _agreement(model, ex, dtype):
    got, want = model(ex), _plain_forward(model, ex)
    mask_err = (got.mask - want.mask).abs().max().item()
    peak = want.time_estimate.abs().max().item()
    wave_err = (got.time_estimate - want.time_estimate).abs().max().item() / peak
    log(f'serve {dtype}: kernels against plain versions: mask max abs err '
        f'{mask_err:.3g}, waveform max abs err / peak {wave_err:.3g} '
        f'(tolerance {SERVE_ATOL[dtype]})')
    check(mask_err <= SERVE_ATOL[dtype], f'{dtype} served masks')
    check(wave_err <= SERVE_ATOL[dtype], f'{dtype} served waveforms')


def phase_serving():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = Model.from_config(FLAGSHIP, storage_dtype=BF16, device='cuda')
    model.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator(device='cuda').manual_seed(1)
    warm, *requests = [make_request(gen, SERVE_BATCH)
                       for _ in range(1 + REQUESTS)]
    model(warm)
    torch.cuda.synchronize()

    _reset_launches()
    times = []
    for ex in requests:
        t0 = time.perf_counter()
        out = model(ex)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        check(out.mask.shape == (SERVE_BATCH, SPEAKERS, 1, FRAMES, BINS),
              f'mask shape {tuple(out.mask.shape)}')
        check(out.time_estimate.shape == (SERVE_BATCH, SPEAKERS, SAMPLES),
              f'waveform shape {tuple(out.time_estimate.shape)}')
        check(bool(torch.isfinite(out.mask).all()), 'finite masks')
        check(bool(torch.isfinite(out.time_estimate).all()),
              'finite waveforms')
    launches = _launches()
    log(f'serve: {REQUESTS} requests of batch {SERVE_BATCH}, ms each '
        f'{[round(t, 2) for t in times]}, launches {launches}')
    check(launches == {'blstm_fullfused_fwd': 3 * REQUESTS,
                       'blstm_bidi_fwd': REQUESTS,
                       'blstm_fullfused_bwd': 0, 'blstm_bidi_bwd': 0},
          f'3 fully fused and 1 bidi launch per request, got {launches}')

    _agreement(model, requests[0], BF16)
    model32 = Model.from_config(FLAGSHIP, storage_dtype=F32, device='cuda')
    model32.load_state_dict(model.state_dict())
    _agreement(model32, requests[0], F32)
    return launches


def _step_grads(model, batch, plain):
    """Loss and every parameter's gradient of one step on ``batch``, in the
    input's speaker order, through the kernels or the plain versions."""
    model.zero_grad(set_to_none=True)
    with _plain_versions() if plain else contextlib.nullcontext():
        loss, _ = model.loss_fn(batch, None, training=True)
        loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def _train_agreement(model, batch, dtype):
    loss, grads = _step_grads(model, batch, plain=False)
    loss_plain, grads_plain = _step_grads(model, batch, plain=True)
    rel = {n: ((grads[n] - g).abs().max()
               / g.abs().max().clamp(min=1e-30)).item()
           for n, g in grads_plain.items()}
    worst = max(rel, key=rel.get)
    log(f'train {dtype}: kernels against plain versions: loss {loss:.6f} '
        f'vs {loss_plain:.6f}, gradients max abs err / max abs over '
        f'{len(rel)} parameters {rel[worst]:.3g} ({worst}) (tolerance '
        f'{TRAIN_TOL[dtype]})')
    check(abs(loss - loss_plain) <= TRAIN_TOL[dtype], f'{dtype} step loss')
    check(rel[worst] <= TRAIN_TOL[dtype], f'{dtype} step gradients')
    return {'loss': loss, 'loss_plain': loss_plain,
            'max_rel_grad_err': rel[worst], 'worst_param': worst}


_STEP_KERNELS = {'forward kernels': ('blstm_fwd_kernel',),
                 'backward kernels': ('blstm_bwd_walk_kernel', 'wgrad_kernel',
                                      'dx_kernel')}


def _profile_step(trainer, batch):
    """Device time of one training step by kernel group, from
    ``torch.profiler``; None where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    split = dict.fromkeys(list(_STEP_KERNELS) + ['other device work'], 0.0)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, 'self_device_time_total', None)
        if us is None:
            us = evt.self_cuda_time_total
        group = next((g for g, names in _STEP_KERNELS.items()
                      if any(n in evt.key for n in names)),
                     'other device work')
        split[group] += us / 1e3
    busy = sum(split.values())
    if busy == 0:
        return None
    split['device idle'] = wall_ms - busy
    split['wall (profiled)'] = wall_ms
    return split


def phase_training(rows):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = Model.from_config(FLAGSHIP, storage_dtype=BF16, device='cuda')
    model.init_params(torch.Generator().manual_seed(0))
    sim = DeviceMeetingSimulator(duration=SAMPLES / 16000,
                                 num_speakers=SPEAKERS, aux_size=BINS)
    data = DeviceSimDataset(sim, TRAIN_BATCH, seed=2,
                            targets=model.loss.device_targets() | {'Vad'},
                            device='cuda')
    trainer = Trainer(model, Adam(gradient_clipping=10, lr=1e-3), seed=0)

    _reset_launches()
    t0 = time.perf_counter()
    losses = trainer.train(data, TRAIN_STEPS)
    train_s = time.perf_counter() - t0
    launches = _launches()
    log(f'train: Trainer.train {TRAIN_STEPS} steps of batch {TRAIN_BATCH} '
        f'in {train_s:.2f} s (first calls included), losses {losses}, '
        f'launches {launches}')
    check(len(losses) == TRAIN_STEPS, 'a loss per step')
    check(all(map(math.isfinite, losses)), 'finite losses')
    check(launches == {'blstm_fullfused_fwd': 3 * TRAIN_STEPS,
                       'blstm_bidi_fwd': TRAIN_STEPS,
                       'blstm_fullfused_bwd': 3 * TRAIN_STEPS,
                       'blstm_bidi_bwd': TRAIN_STEPS},
          f'3 fully fused and 1 bidi launch forward and backward per step, '
          f'got {launches}')

    # steady-state steps on fresh batches: the batch's generation and the
    # step are timed apart, each ending in a synchronize
    it = iter(data)
    gen_ms, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch = next(it)
        torch.cuda.synchronize()
        gen_ms.append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
    log(f'train: step ms {[round(t, 2) for t in step_ms]}, batch generation '
        f'ms {[round(t, 2) for t in gen_ms]}')

    # the kernels' share of a step: the kernels phase's times at the same
    # shapes (forward measured without c), and the profiler where it works
    est = {'forward kernels': sum(
        r['ms'] for name in ('blstm_fullfused_fwd', 'blstm_bidi_fwd')
        for r in rows[name] if ' serve ' in r['name']
        and r['dtype'] == 'bfloat16'),
        'backward kernels': sum(
        r['ms'] for name in ('blstm_fullfused_bwd', 'blstm_bidi_bwd')
        for r in rows[name] if ' train ' in r['name']
        and r['dtype'] == 'bfloat16')}
    est['rest'] = min(step_ms) - sum(est.values())
    log(f'train: step split from the kernels phase (ms): {json.dumps(est)}')
    try:
        split = _profile_step(trainer, batch)
    except (RuntimeError, AttributeError) as exc:
        split = None
        log(f'train: profiler failed: {exc}')
    log(f'train: step split from torch.profiler (ms): '
        f'{json.dumps(split) if split else "not measured"}')

    agree = {'bfloat16': _train_agreement(model, batch, BF16)}
    model32 = Model.from_config(FLAGSHIP, storage_dtype=F32, device='cuda')
    model32.load_state_dict(model.state_dict())
    agree['float32'] = _train_agreement(model32, batch, F32)
    return {'launches': launches, 'losses': losses, 'step_ms': step_ms,
            'gen_ms': gen_ms, 'split_estimate': est, 'split_profiler': split,
            'agreement': agree}


def kernels_line(rows, serve_launches, train_launches):
    """Per kernel: the numbers of one served request (forward kernels) or
    one training step (backward kernels) at batch 16 in bfloat16 storage,
    summed over its calls; the launches of the serving and training runs;
    and every call measured."""
    kernels = []
    for name, calls in rows.items():
        tag = ' serve ' if name.endswith('_fwd') else ' train '
        path = [r for r in calls if tag in r['name']
                and r['dtype'] == 'bfloat16']
        top = max(path, key=lambda r: r['bound_ms'])
        lib = [r['library_ms'] for r in path]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': SOURCES[name][0],
            'replaces': SOURCES[name][1],
            'launches': serve_launches[name] + train_launches[name],
            'launches_per_request': serve_launches[name] / REQUESTS,
            'launches_per_step': train_launches[name] / TRAIN_STEPS,
            'max_abs_err': max(r['max_abs_err'] for r in path),
            'ms': sum(r['ms'] for r in path),
            'plain_ms': sum(r['plain_ms'] for r in path),
            'bound_ms': sum(r['bound_ms'] for r in path),
            'bound_by': top['bound_by'],
            'library_ms': None if None in lib else sum(lib),
            'calls': calls,
        })
    return {'kernels': kernels}


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    log(f'-- build done at {time.perf_counter() - t0:.1f} s')
    rows = phase_kernels()
    log(f'-- kernels done at {time.perf_counter() - t0:.1f} s')
    serve_launches = phase_serving()
    log(f'-- serving done at {time.perf_counter() - t0:.1f} s')
    training = phase_training(rows)
    log(f'-- training done at {time.perf_counter() - t0:.1f} s')
    log(json.dumps({'training': training}))
    print(json.dumps(kernels_line(rows, serve_launches,
                                  training['launches'])))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
