"""Drive the PyTorch port (``tssep_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each of which must pass:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: the CUDA kernels, one ``nvcc`` per source started together, with
   ``-Xptxas -v``'s registers, shared memory and spills, summed up for the
   clustered kernels of the bfloat16 route;
3. kernels: each kernel against its plain PyTorch version on the card, in
   float32 and in bfloat16 storage, with max error, kernel time, plain time
   and bound: the forward kernels at a ragged small shape, at the shapes of
   a served request (batch 16) and at the flagship training shapes (batch
   256); the backward kernels at a ragged shape and at the training shapes
   of batch 16 and of batch 256; the fully fused pair also at the toy
   recipe's ``pre_net`` (16 rows, F 553) and ``birnn1`` at 2 permutation
   trials (256 rows, F 320; its ``birnn0``, 256 rows at F 513, is the
   batch-256 ``pre_net`` row). Every pair runs, in bfloat16, the
   clustered Hopper kernels (``csrc/blstm_cluster_*.cuh``; the bidi pair in
   their gate-input form, the one-direction pair in that form on a grid of
   one direction, the conditioned pair in their conditioned form, the
   spill pair with the forward writing the c boundaries and the walk
   rebuilding c): each forward is timed beside the first design's kernels
   doing the same work (the fully fused forward's own first design, run
   through the spill forward's f32 route in bf16, without boundaries; the
   one-direction pair's first design for each direction of the bidi pair;
   the other pairs' own first designs), the backward by its launches (gate
   product, walk, weight sums and, fully fused and spill, dx; conditioned,
   dcond and its split), each between CUDA events, and beside its first
   design (the bidi backward beside the one-direction first design for each
   direction). The conditioned pair is also timed beside the route the
   default model takes on the same work: the materialized product and the
   clustered fully fused kernel at B S rows; the spill pair beside the fully
   fused pair on the same work. In bfloat16 the spill forward's h is held
   bit for bit against the fully fused forward's, and its boundaries
   against that forward's saved c; the one-direction pair on each half of
   the bidi pair's xg against the bidi pair: h, c and dxg bit for bit, dW_hh
   at ``CLUSTER_TOL``, and its backward gives the same bits twice. The
   gate-input kernels (the bidi and the one-direction pair) are timed
   beside one cuDNN LSTM call that computes their function from xg: input
   weights that select xg's columns, zero biases;
4. serving: the flagship TS-SEP model (``bench.py:98-106``, random weights
   from a seed) answers 3 requests of batch 16 through the kernels, which the
   launch counters prove, and its masks and waveforms agree with the same
   model run through the plain versions;
5. serving with ``cond_fuse``: the same weights answer 3 requests of batch
   16, then 1 request with 2 permutation trials, through the conditioned
   first post-net layer; masks and waveforms agree with the model without
   ``cond_fuse`` and with the plain versions; the peak memory of one request
   with and without ``cond_fuse`` (so too 9 and 10);
6. training: the same model trains 3 steps at batch 16 on batches from the
   port's on-device simulator (``Trainer.train``, LogMAE, clipped Adam),
   through all four kernels of its path, with finite losses; then one
   step's loss and every parameter's gradient agree with those through the
   plain versions, in bfloat16 and in float32 storage;
7. training with ``cond_fuse``: 3 steps as in 6 through the conditioned
   layer, one step's loss and gradients against the plain versions and
   against the default model, the peak memory of a step with and without
   the switch, and one profiled step (so too 8, 11, 12 and 13);
8. training with ``fullfuse=False``: 2 steps, every layer through the
   gate-input kernels;
9. serving with ``spill``: 3 requests, ``pre_net``, ``birnn0`` and
   ``birnn1`` through the spill forward; masks and waveforms bit for bit
   the default model's, and against the plain versions;
10. serving with ``bidi=False``: the same, ``birnn2`` one direction at a
    time through ``lstm_fwd``;
11. training with ``spill``: 3 steps through the spill pair;
12. training with ``bidi=False``: 3 steps with ``birnn2`` through the
    unidirectional pair;
13. training with ``fullfuse=False, bidi=False``: 2 steps, every direction
    of every layer through the unidirectional pair;
14. the toy recipe's TS-VAD stage (``tssep_tpu/exp/init_cfg_common.yaml``
    with ``init_cfg_tsvad.yaml``: MFCC40 ⊕ Log1pMaxNorm features, 553 wide,
    2 permutation trials, 't' resolution, ``VADSigmoidBCE``) at the
    flagship's widths, built by ``Model.from_config``: 3 requests of batch
    16 served, then 3 training steps at batch 16 on the simulator's ``Vad``
    targets, each against the plain versions;
15. the recipe's TS-SEP stage (the same model, 'tf' and LogMAE) served;
16. the flagship with ``SoudenMVDR`` (nmask 2, a head twice as wide) served
    on requests of 7 channels.

Before them a ``cond_fuse``, a ``spill`` and a ``bidi=False`` line sum up
the conditioned, the spill and the one-direction pair in bfloat16 at batch
16: each kernel's
time, bound, first design's time, the time of the route it is compared
with (materialized, or fully fused) and cuDNN yardstick, the backward's
parts, and the times and peak memory of serving and training with the
switch. The last two lines of standard
output are the kernels' JSON line and the device's JSON line. Without CUDA
it exits with code 1 and prints no result.
"""

from __future__ import annotations

import sys

sys.dont_write_bytecode = True        # write nothing into the checkout

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
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
#: The toy recipe's features (``tssep_tpu/exp/init_cfg_common.yaml``, copied:
#: the card's machine may lack a YAML reader): MFCC40 ⊕ Log1pMaxNorm.
RECIPE_FE = {
    'factory': 'ConcatenatedSTFTFeatures',
    'fe1': {'factory': 'MFCC', 'size': 1024, 'shift': 256,
            'window_length': 1024, 'pad': True, 'fading': True,
            'output_size': 40, 'window': 'hann', 'sample_rate': 16000,
            'n_mfcc': 40, 'dct_norm': 'ortho', 'log_mels': False,
            'f_min': 40, 'f_max': -400, 'n_mels': 40, 'mel_norm': None,
            'mel_scale': 'htk'},
    'fe2': {'factory': 'Log1pMaxNormAbsSTFT', 'size': 1024, 'shift': 256,
            'window_length': 1024, 'pad': True, 'fading': True,
            'output_size': 513, 'window': 'hann', 'statistics_axis': 'tf'},
    'output_size': 553, 'size': 1024, 'shift': 256, 'window': 'hann',
    'window_length': 1024, 'pad': True, 'fading': True}
#: The recipe's TS-VAD stage (``init_cfg_tsvad.yaml``) at the flagship's
#: widths (units 300, projs 320 where the recipe has 40 and 42).
TSVAD = {
    'fe': RECIPE_FE,
    'mask_estimator': {
        'idim': 553, 'odim': 513, 'layers': 3, 'units': 300, 'projs': 320,
        'dropout': 0, 'nmask': 1, 'pre_net': 'RNNP', 'aux_net': None,
        'aux_net_output_size': 513, 'combination': 'mul', 'ts_vad': 8,
        'random_speaker_order': True, 'num_averaged_permutations': 2,
        'input_normalizer': None, 'aux_normalizer': None,
        'explicit_vad': False, 'output_resolution': 't'},
    'enhancer': {'factory': 'Masking'},
    'loss': {'factory': 'VADSigmoidBCE', 'target': 'Vad', 'pit': False,
             'magnitude_threshold': 0.05},
}
#: The recipe's TS-SEP stage (``init_cfg_tssep.yaml``): 'tf' and LogMAE.
TSSEP_RECIPE = dict(
    TSVAD, mask_estimator=dict(TSVAD['mask_estimator'],
                               output_resolution='tf'),
    loss={'factory': 'LogMAE', 'target': 'speaker_reverberation_early_ch0'})
#: The flagship with the MVDR enhancer (nmask 2), served on the LibriCSS
#: array's 7 channels.
MVDR = dict(FLAGSHIP, enhancer={'factory': 'SoudenMVDR'})
MVDR_CHANNELS = 7
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
#: The clustered kernels' bfloat16 route: forward max abs error of h and c,
#: backward each output's error over its peak. One bf16 ulp of c (2^-6
#: between 2 and 4) flipped by another f32 sum order; dx rounded to bf16 per
#: direction (the conditioned dx and daux once), the gate gradients
#: entering the tensor cores as a two-term bf16 split (relative error
#: ~2^-16).
CLUSTER_TOL = {'blstm_fullfused_fwd': 1.6e-2, 'blstm_fullfused_bwd': 5e-3,
               'blstm_bidi_fwd': 1.6e-2, 'blstm_bidi_bwd': 5e-3,
               'blstm_fullfused_cond_fwd': 1.6e-2,
               'blstm_fullfused_cond_bwd': 5e-3,
               'blstm_fullfused_spill_fwd': 1.6e-2,
               'blstm_fullfused_spill_bwd': 5e-3,
               'lstm_fwd': 1.6e-2, 'lstm_bwd': 5e-3}
#: The sources of the kernels each wrapper launches, by storage type.
_CLUSTERED = {
    'fwd': {'bfloat16': 'tssep_tpu_torch/kernels/csrc/blstm_cluster_fwd.cuh',
            'float32': 'tssep_tpu_torch/kernels/csrc/blstm_common.cuh'},
    'bwd': {'bfloat16': 'tssep_tpu_torch/kernels/csrc/blstm_cluster_bwd.cuh',
            'float32': 'tssep_tpu_torch/kernels/csrc/blstm_bwd_common.cuh'}}
DESIGNS = {'blstm_fullfused_fwd': _CLUSTERED['fwd'],
           'blstm_fullfused_bwd': _CLUSTERED['bwd'],
           'blstm_bidi_fwd': _CLUSTERED['fwd'],
           'blstm_bidi_bwd': _CLUSTERED['bwd'],
           'blstm_fullfused_cond_fwd': _CLUSTERED['fwd'],
           'blstm_fullfused_cond_bwd': _CLUSTERED['bwd'],
           'blstm_fullfused_spill_fwd': _CLUSTERED['fwd'],
           'blstm_fullfused_spill_bwd': _CLUSTERED['bwd'],
           'lstm_fwd': _CLUSTERED['fwd'], 'lstm_bwd': _CLUSTERED['bwd']}
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
    'blstm_fullfused_cond_fwd': ('tssep_tpu_torch/kernels/csrc/'
                                 'blstm_fullfused_cond_fwd.cu',
                                 'tssep_tpu/kernels/blstm.py:1656'),
    'blstm_fullfused_cond_bwd': ('tssep_tpu_torch/kernels/csrc/'
                                 'blstm_fullfused_cond_bwd.cu',
                                 'tssep_tpu/kernels/blstm.py:1707'),
    'blstm_fullfused_spill_fwd': ('tssep_tpu_torch/kernels/csrc/'
                                  'blstm_fullfused_spill_fwd.cu',
                                  'tssep_tpu/kernels/blstm.py:1228'),
    'blstm_fullfused_spill_bwd': ('tssep_tpu_torch/kernels/csrc/'
                                  'blstm_fullfused_spill_bwd.cu',
                                  'tssep_tpu/kernels/blstm.py:1280'),
    'lstm_fwd': ('tssep_tpu_torch/kernels/csrc/lstm_fwd.cu',
                 'tssep_tpu/kernels/blstm.py:52'),
    'lstm_bwd': ('tssep_tpu_torch/kernels/csrc/lstm_bwd.cu',
                 'tssep_tpu/kernels/blstm.py:82'),
}
KERNELS = tuple(SOURCES)
#: The toy recipe's new shapes of the fully fused pair, at batch 16: pre_net on
#: the 553 features, birnn1 at 2 permutation trials (256 rows; birnn0 there is
#: the 'pre_net' row at batch 256).
RECIPE_CASES = [('recipe pre_net', 16, FRAMES, 553, HIDDEN),
                ('recipe birnn1', 16 * 2 * SPEAKERS, FRAMES, 320, HIDDEN)]
#: (label, B, T, F, H) of the fully fused kernel's calls and (label, B, T, H)
#: of the bidi kernel's. The 'serve' rows are one request of batch 16, the
#: others the flagship training shapes at batch 256.
FULLFUSED_CASES = [('ragged', 13, 23, 12, 16),
                   ('serve pre_net', 16, FRAMES, BINS, HIDDEN),
                   ('serve birnn0', 16 * SPEAKERS, FRAMES, BINS, HIDDEN),
                   ('serve birnn1', 16 * SPEAKERS, FRAMES, 320, HIDDEN),
                   ('pre_net', 256, FRAMES, BINS, HIDDEN),
                   ('birnn0', 256 * SPEAKERS, FRAMES, BINS, HIDDEN),
                   ('birnn1', 256 * SPEAKERS, FRAMES, 320, HIDDEN),
                   *RECIPE_CASES]
#: 'fullfuse=False' rows are the folded layers' calls on that path.
BIDI_CASES = [('ragged', 13, 23, 16),
              ('serve birnn2', 16, FRAMES, HIDDEN),
              ('birnn2', 256, FRAMES, HIDDEN),
              ('fullfuse=False birnn0', 16 * SPEAKERS, FRAMES, HIDDEN)]
#: The backward kernels' calls: 'train' rows are one training step at
#: batch 16, the others the bench's batch 256.
FULLFUSED_BWD_CASES = [('ragged', 13, 23, 12, 16),
                       ('train pre_net', 16, FRAMES, BINS, HIDDEN),
                       ('train birnn0', 16 * SPEAKERS, FRAMES, BINS, HIDDEN),
                       ('train birnn1', 16 * SPEAKERS, FRAMES, 320, HIDDEN),
                       ('pre_net', 256, FRAMES, BINS, HIDDEN),
                       ('birnn0', 256 * SPEAKERS, FRAMES, BINS, HIDDEN),
                       ('birnn1', 256 * SPEAKERS, FRAMES, 320, HIDDEN),
                       *RECIPE_CASES]
BIDI_BWD_CASES = [('ragged', 13, 23, 16),
                  ('train birnn2', 16, FRAMES, HIDDEN),
                  ('birnn2', 256, FRAMES, HIDDEN),
                  ('fullfuse=False birnn0', 16 * SPEAKERS, FRAMES, HIDDEN)]
#: (label, B, S, T, F, H) of the conditioned kernels' calls: two ragged
#: shapes (the second with 8-row tiles that straddle groups of 3 speakers
#: and CTAs that own no unit), birnn0 of a served request or a training step
#: at batch 16 (128 rows), and at batch 256 (2048 rows, more than one wave).
COND_CASES = [('ragged', 3, 4, 23, 12, 16),
              ('ragged S=3', 5, 3, 37, 40, 37),
              ('serve birnn0', 16, SPEAKERS, FRAMES, BINS, HIDDEN),
              ('birnn0', 256, SPEAKERS, FRAMES, BINS, HIDDEN)]
COND_BWD_CASES = [(label.replace('serve', 'train'), *dims)
                  for label, *dims in COND_CASES]
#: The yardstick of the conditioned kernels: no single PyTorch call computes
#: the layer, so the materialized product and cuDNN's LSTM, timed together.
COND_LIBRARY = 'product + cuDNN, 2 calls'
#: The spill pair's calls, (label, B, T, F, H): the fully fused layers of a
#: served request or a training step at batch 16, and at batch 256; the
#: ragged T has 5 spill blocks, the last one short.
SPILL_CASES = [('ragged', 13, 37, 12, 16),
               ('serve pre_net', 16, FRAMES, BINS, HIDDEN),
               ('serve birnn0', 16 * SPEAKERS, FRAMES, BINS, HIDDEN),
               ('serve birnn1', 16 * SPEAKERS, FRAMES, 320, HIDDEN),
               ('pre_net', 256, FRAMES, BINS, HIDDEN),
               ('birnn0', 256 * SPEAKERS, FRAMES, BINS, HIDDEN),
               ('birnn1', 256 * SPEAKERS, FRAMES, 320, HIDDEN)]
SPILL_BWD_CASES = [(label.replace('serve', 'train'), *dims)
                   for label, *dims in SPILL_CASES]
#: The unidirectional pair's calls, (label, B, T, H, reverse): both
#: directions of birnn2 with ``bidi=False`` at batch 16 and 256, and one
#: direction of birnn0 with ``fullfuse=False, bidi=False``.
LSTM_CASES = [(label, B, T, H, rev) for label, B, T, H in (
    ('ragged', 13, 23, 16), ('serve birnn2', 16, FRAMES, HIDDEN),
    ('birnn2', 256, FRAMES, HIDDEN)) for rev in (False, True)] + [
    ('fullfuse=False birnn0', 16 * SPEAKERS, FRAMES, HIDDEN, True)]
LSTM_BWD_CASES = [(label.replace('serve', 'train'), *dims)
                  for label, *dims in LSTM_CASES]



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


#: Kernel names of the clustered bfloat16 route, as ptxas and the profiler
#: show them.
CLUSTER_KERNELS = ('cluster_fwd_kernel', 'cluster_walk_kernel', 'GatesOp',
                   'WgradOp', 'DxOp', 'DcondOp', 'splitk_add_kernel')
#: The walk's spill form: ``cluster_walk_kernel`` with its last template
#: argument true, ``Lb1E`` at the end of the mangled template arguments.
SPILL_WALK = 'cluster_walk_kernel, spill form'


def _ptxas_summary(log_text):
    """(kernel, its ptxas lines) for each clustered kernel of the build."""
    lines = [line.strip() for line in log_text.splitlines()]
    for i, line in enumerate(lines):
        if 'Compiling entry function' in line and any(
                k in line for k in CLUSTER_KERNELS):
            name = next(k for k in CLUSTER_KERNELS if k in line)
            if name == 'cluster_walk_kernel' and 'Lb1EEEv' in line:
                name = SPILL_WALK
            tail = [t for t in lines[i + 1:i + 4]
                    if 'registers' in t or 'spill stores' in t or 'smem' in t]
            yield name, line.split("'")[1] if "'" in line else line, tail


def phase_build():
    result = _build.build()
    log(f'build: {len(_build._sources())} nvcc calls side by side and a link, '
        f'{result.seconds:.1f} s -> {result.path.name}')
    for line in result.log.splitlines():
        if line.strip():
            log(f'  {line.strip()}')
    log('ptxas, clustered kernels (bf16 route of the fully fused, bidi, '
        'one-direction, conditioned and spill pairs):')
    for name, entry, tail in _ptxas_summary(result.log):
        log(f'  {name}: {entry}: {" | ".join(tail)}')
    _build.library()


def _uniform(gen, shape, bound_, dtype):
    draw = torch.rand(shape, generator=gen, device='cuda')
    return ((2 * draw - 1) * bound_).to(dtype)


def _max_err(got, want):
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def _case(name, dtype, run, run_plain, outputs, plain_outputs, flops,
          nbytes, library=None, library_label='cuDNN', tol=None):
    err = _max_err(outputs, plain_outputs)
    tol = KERNEL_ATOL[dtype] if tol is None else tol
    check(err <= tol, f'{name} max abs error {err:.3g} > {tol}')
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
            'library_ms': library_ms,
            'library': library_label if library else None}


def _fullfused_inputs(B, T, F, H, dtype, gen):
    """x, w_ih_t, w_hh_t, bias of one fully fused layer."""
    x = torch.randn(B, T, F, generator=gen, device='cuda').to(dtype)
    b = 1 / H ** 0.5
    w_ih_t = _uniform(gen, (2, F, 4 * H), b, dtype)
    w_hh_t = _uniform(gen, (2, H, 4 * H), b, dtype)
    bias = _uniform(gen, (2, 4 * H), 2 * b, F32)
    return x, w_ih_t, w_hh_t, bias


def fullfused_case(label, B, T, F, H, dtype, gen):
    size = torch.finfo(dtype).bits // 8
    x, w_ih_t, w_hh_t, bias = _fullfused_inputs(B, T, F, H, dtype, gen)
    got = kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias, with_cell=True)
    want = kb.blstm_fullfused_fwd_plain(x, w_ih_t, w_hh_t, bias,
                                        with_cell=True)
    lstm = torch.nn.LSTM(F, H, bidirectional=True, batch_first=True,
                         device='cuda', dtype=dtype)
    lstm.flatten_parameters()
    row = _case(
        f'blstm_fullfused_fwd {label} B={B} T={T} F={F} H={H}', dtype,
        lambda: kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias),
        lambda: kb.blstm_fullfused_fwd_plain(x, w_ih_t, w_hh_t, bias),
        got, want, flops=2 * B * T * 2 * (F + H) * 4 * H,
        nbytes=size * (B * T * F + 2 * (F + H) * 4 * H + B * T * 2 * H)
        + 4 * 2 * 4 * H,
        library=lambda: lstm(x),
        tol=CLUSTER_TOL['blstm_fullfused_fwd'] if dtype == BF16 else None)
    row['design'] = DESIGNS['blstm_fullfused_fwd'][row['dtype']]
    if dtype == BF16:
        # the first design's kernel on the same work: the spill forward's
        # first design writes h only, without boundaries, as the fully fused
        # one did
        row['first_design_ms'] = cuda_ms(
            lambda: kb._fullfused_spill_fwd_first(x, w_ih_t, w_hh_t, bias,
                                                  False))
        row['geometry'] = dataclasses.asdict(
            kb._geometry('fwd', B, F, H, x.device))
    return row


def spill_case(label, B, T, F, H, dtype, gen):
    """The spill forward against its plain version, h and the boundaries;
    timed as it runs on its path: a served layer writes no boundaries."""
    size = torch.finfo(dtype).bits // 8
    x, w_ih_t, w_hh_t, bias = _fullfused_inputs(B, T, F, H, dtype, gen)
    got = kb.blstm_fullfused_spill_fwd(x, w_ih_t, w_hh_t, bias,
                                       with_boundaries=True)
    want = kb.blstm_fullfused_spill_fwd_plain(x, w_ih_t, w_hh_t, bias,
                                              with_boundaries=True)
    lstm = torch.nn.LSTM(F, H, bidirectional=True, batch_first=True,
                         device='cuda', dtype=dtype)
    lstm.flatten_parameters()
    bounds = not label.startswith('serve')
    nblk = -(-T // kb.SPILL_BLOCK)
    row = _case(
        f'blstm_fullfused_spill_fwd {label} B={B} T={T} F={F} H={H}', dtype,
        lambda: kb.blstm_fullfused_spill_fwd(x, w_ih_t, w_hh_t, bias,
                                             with_boundaries=bounds),
        lambda: kb.blstm_fullfused_spill_fwd_plain(
            x, w_ih_t, w_hh_t, bias, with_boundaries=bounds),
        got, want, flops=2 * B * T * 2 * (F + H) * 4 * H,
        nbytes=size * (B * T * F + 2 * (F + H) * 4 * H + B * T * 2 * H
                       + bounds * 2 * nblk * B * H) + 4 * 2 * 4 * H,
        library=lambda: lstm(x),
        tol=CLUSTER_TOL['blstm_fullfused_spill_fwd'] if dtype == BF16
        else None)
    row['design'] = DESIGNS['blstm_fullfused_spill_fwd'][row['dtype']]
    if dtype == BF16:
        row['identical_to_fullfused'] = _spill_bits(
            got, x, w_ih_t, w_hh_t, bias)
        row['first_design_ms'] = cuda_ms(
            lambda: kb._fullfused_spill_fwd_first(x, w_ih_t, w_hh_t, bias,
                                                  bounds))
        # the fully fused forward on the same work, with c where the spill
        # forward writes boundaries
        row['fullfused_ms'] = cuda_ms(lambda: kb.blstm_fullfused_fwd(
            x, w_ih_t, w_hh_t, bias, with_cell=bounds))
        row['geometry'] = dataclasses.asdict(
            kb._geometry('fwd', B, F, H, x.device))
    return row


def _spill_bits(got, x, w_ih_t, w_hh_t, bias):
    """The bf16 spill forward's h is the fully fused forward's, bit for bit,
    on the same input, and each boundary slot k > 0 is that forward's saved
    c after walk step k SPILL_BLOCK - 1 (t = that step forward, T - k
    SPILL_BLOCK reverse); slot 0 is zero. Checks; returns True."""
    h, cb = got
    T, H = x.shape[1], w_hh_t.shape[1]
    h_ff, c_ff = kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias,
                                        with_cell=True)
    check(torch.equal(h, h_ff), 'the spill forward\'s h is the fully fused '
          'forward\'s, bit for bit')
    S = kb.SPILL_BLOCK
    same = not cb[:, 0].any() and all(
        torch.equal(cb[0, k], c_ff[:, S * k - 1, :H])
        and torch.equal(cb[1, k], c_ff[:, T - S * k, H:])
        for k in range(1, cb.shape[1]))
    check(same, 'each boundary slot is the fully fused forward\'s saved c')
    return True


def lstm_case(label, B, T, H, reverse, dtype, gen):
    size = torch.finfo(dtype).bits // 8
    xg = torch.randn(B, T, 4 * H, generator=gen, device='cuda').to(dtype)
    w_hh_t = _uniform(gen, (H, 4 * H), 1 / H ** 0.5, dtype)
    got = kb.lstm_fwd(xg, w_hh_t, reverse=reverse, with_cell=True)
    want = kb.lstm_fwd_plain(xg, w_hh_t, reverse=reverse, with_cell=True)
    name = (f'lstm_fwd {label} B={B} T={T} H={H} '
            f'{"reverse" if reverse else "forward"}')
    library = _selection_lstm(name, xg, w_hh_t[None], want[0], dtype,
                              reverse=reverse)
    row = _case(
        name, dtype, lambda: kb.lstm_fwd(xg, w_hh_t, reverse=reverse),
        lambda: kb.lstm_fwd_plain(xg, w_hh_t, reverse=reverse),
        got, want, flops=2 * B * T * H * 4 * H,
        nbytes=size * (B * T * 4 * H + H * 4 * H + B * T * H),
        library=library.forward, library_label=SELECTION_LIBRARY,
        tol=CLUSTER_TOL['lstm_fwd'] if dtype == BF16 else None)
    row['design'] = DESIGNS['lstm_fwd'][row['dtype']]
    if dtype == BF16:
        row['first_design_ms'] = cuda_ms(
            lambda: kb._lstm_fwd_first(xg, w_hh_t, reverse, False))
        row['geometry'] = dataclasses.asdict(kb._geometry(
            'fwd_xg', B, 4 * H, H, xg.device, 'uni', directions=1))
    return row


#: The yardstick of the gate-input kernels: one cuDNN LSTM call whose input
#: weights select xg's columns (x W_ih^T = xg exactly, in any storage type)
#: and whose biases are zero, so that it computes the kernel's function.
SELECTION_LIBRARY = 'cuDNN LSTM on xg, selection input weights'
#: Its h against the plain version's, max abs error: cuDNN keeps its own
#: order of sums and, in bfloat16, its own roundings inside the step.
SELECTION_ATOL = {F32: 1e-4, BF16: 5e-2}


class _Selection:
    """cuDNN's LSTM set up to compute a gate-input kernel's function: the
    call (``forward``) and its backward from a kept graph (``backward``,
    made on first use), on the inputs the kernel takes."""

    def __init__(self, lstm, xg_in, h_out):
        self.lstm, self.xg_in, self.h_out = lstm, xg_in, h_out

    def forward(self):
        return self.lstm(self.xg_in)

    def backward(self, dh):
        xg_leaf = self.xg_in.detach().requires_grad_()
        out, _ = self.lstm(xg_leaf)
        weights = [p for n, p in self.lstm.named_parameters()
                   if n.startswith('weight_hh')]
        return lambda: torch.autograd.grad(out, [xg_leaf, *weights],
                                           self.h_out(dh), retain_graph=True)


def _selection_lstm(name, xg, w_hh_t, h_ref, dtype, reverse=False,
                    ref='the plain version'):
    """cuDNN's ``torch.nn.LSTM`` with input width G = 4H n (n directions),
    ``weight_ih`` of direction d the selection [0 .. I_4H .. 0] of xg's
    columns [4H d, 4H (d + 1)), zero biases and ``weight_hh`` = w_hh_t[d]^T:
    h = the gate-input kernel's h on xg. One direction with ``reverse``
    runs on the time-flipped xg (flipped once, outside the timed call).
    Checks its h against ``h_ref``, the plain version's (or, where ``ref``
    says so, the kernel's); returns the :class:`_Selection`."""
    n, H = w_hh_t.shape[0], w_hh_t.shape[1]
    G = 4 * H * n
    lstm = torch.nn.LSTM(G, H, bidirectional=n == 2, batch_first=True,
                         device='cuda', dtype=dtype)
    eye = torch.eye(4 * H, device='cuda', dtype=dtype)
    with torch.no_grad():
        for d, suffix in enumerate(['', '_reverse'][:n]):
            w_ih = getattr(lstm, f'weight_ih_l0{suffix}')
            w_ih.zero_()
            w_ih[:, 4 * H * d:4 * H * (d + 1)] = eye
            getattr(lstm, f'weight_hh_l0{suffix}').copy_(w_hh_t[d].T)
            getattr(lstm, f'bias_ih_l0{suffix}').zero_()
            getattr(lstm, f'bias_hh_l0{suffix}').zero_()
    lstm.flatten_parameters()
    xg_in = xg.flip(1).contiguous() if reverse else xg.contiguous()
    flip = (lambda t: t.flip(1)) if reverse else (lambda t: t)
    with torch.no_grad():
        h = flip(lstm(xg_in)[0])
    err = (h.float() - h_ref.float()).abs().max().item()
    log(f'{name}: {SELECTION_LIBRARY}: h max abs err against {ref} '
        f'{err:.3g} (tolerance {SELECTION_ATOL[dtype]})')
    check(err <= SELECTION_ATOL[dtype], f'{name}: the selection LSTM computes '
          f'the kernel\'s function ({err:.3g})')
    return _Selection(lstm, xg_in, flip)


def _cond_inputs(B, S, T, F, H, dtype, gen):
    xs = torch.randn(B, T, F, generator=gen, device='cuda').to(dtype)
    aux = torch.rand(B, S, F, generator=gen, device='cuda').to(dtype)
    b = 1 / H ** 0.5
    w_ih_t = _uniform(gen, (2, F, 4 * H), b, dtype)
    w_hh_t = _uniform(gen, (2, H, 4 * H), b, dtype)
    bias = _uniform(gen, (2, 4 * H), 2 * b, F32)
    return xs, aux, w_ih_t, w_hh_t, bias


def _materialized(xs, aux):
    """The conditioned rows (B S, T, F) as the default model makes them."""
    B, T, F = xs.shape
    return (xs[:, None] * aux[:, :, None]).reshape(B * aux.shape[1], T, F)


def cond_case(label, B, S, T, F, H, dtype, gen):
    size = torch.finfo(dtype).bits // 8
    args = _cond_inputs(B, S, T, F, H, dtype, gen)
    xs, aux, w_ih_t, w_hh_t, bias = args
    got = kb.blstm_fullfused_cond_fwd(*args, with_cell=True)
    want = kb.blstm_fullfused_cond_fwd_plain(*args, with_cell=True)
    lstm = torch.nn.LSTM(F, H, bidirectional=True, batch_first=True,
                         device='cuda', dtype=dtype)
    lstm.flatten_parameters()
    rows = B * S
    # operations: the recurrence's products, and the product xs * aux; bytes:
    # xs, aux and the weights read once, h written once
    row = _case(
        f'blstm_fullfused_cond_fwd {label} B={B} S={S} T={T} F={F} H={H}',
        dtype, lambda: kb.blstm_fullfused_cond_fwd(*args),
        lambda: kb.blstm_fullfused_cond_fwd_plain(*args), got, want,
        flops=2 * rows * T * 2 * (F + H) * 4 * H + rows * T * F,
        nbytes=size * (B * T * F + rows * F + 2 * (F + H) * 4 * H
                       + rows * T * 2 * H) + 4 * 2 * 4 * H,
        library=lambda: lstm(_materialized(xs, aux)),
        library_label=COND_LIBRARY,
        tol=CLUSTER_TOL['blstm_fullfused_cond_fwd'] if dtype == BF16
        else None)
    row['design'] = DESIGNS['blstm_fullfused_cond_fwd'][row['dtype']]
    if dtype == BF16:
        row['first_design_ms'] = cuda_ms(
            lambda: kb._fullfused_cond_fwd_first(*args, False))
        # the default model's route: the product, then the clustered fully
        # fused forward at B S rows; and that kernel alone on the product
        # (made outside the timed call), whose consumers and walk are the
        # conditioned kernel's: the difference is the conditioned staging
        row['materialized_ms'] = cuda_ms(lambda: kb.blstm_fullfused_fwd(
            _materialized(xs, aux), w_ih_t, w_hh_t, bias))
        x = _materialized(xs, aux)
        row['fullfused_ms'] = cuda_ms(
            lambda: kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias))
        del x
        geo = kb._geometry('fwd_cond', rows, F, H, xs.device, 'cond')
        row['geometry'] = dataclasses.asdict(geo)
        split = _split_x_geometry(geo, rows, F, H)
        if split is not None:
            row['split_x_ms'] = cuda_ms(lambda: kb._fullfused_cond_fwd_cluster(
                *args, False, geo=split))
            row['split_x_geometry'] = dataclasses.asdict(split)
    return row


def _split_x_geometry(geo, rows, F, H):
    """Where no plan of the conditioned forward fits one wave, the plan of
    the largest row tile, 32 rows, if it holds the tile's aux rows only with
    x staged in blocks of F (the plan that :func:`kb.cluster_geometry`
    passes over for a smaller tile that stages all of F); else None."""
    KF = -(-F // 16) * 16
    plan = kb._fwd_plan(geo.units // 4, -(-H // 16) * 16, KF, 32, KF)
    if geo.waves == 1 or geo.row_tile == 32 or plan is None or plan[3] == KF:
        return None
    threads, shared, chunk, k_block = plan
    tiles = -(-rows // 32)
    return dataclasses.replace(
        geo, row_tile=32, tiles=tiles, threads=threads, shared=shared,
        chunk=chunk, k_block=k_block, clusters=2 * tiles,
        clusters_per_wave=min(geo.clusters_per_wave, 2 * tiles))


def bidi_case(label, B, T, H, dtype, gen):
    size = torch.finfo(dtype).bits // 8
    xg = torch.randn(B, T, 8 * H, generator=gen, device='cuda').to(dtype)
    w_hh_t = _uniform(gen, (2, H, 4 * H), 1 / H ** 0.5, dtype)
    got = kb.blstm_bidi_fwd(xg, w_hh_t, with_cell=True)
    want = kb.blstm_bidi_fwd_plain(xg, w_hh_t, with_cell=True)
    name = f'blstm_bidi_fwd {label} B={B} T={T} H={H}'
    library = _selection_lstm(name, xg, w_hh_t, want[0], dtype)
    row = _case(
        name, dtype, lambda: kb.blstm_bidi_fwd(xg, w_hh_t),
        lambda: kb.blstm_bidi_fwd_plain(xg, w_hh_t),
        got, want, flops=2 * B * T * 2 * H * 4 * H,
        nbytes=size * (B * T * 8 * H + 2 * H * 4 * H + B * T * 2 * H),
        library=library.forward, library_label=SELECTION_LIBRARY,
        tol=CLUSTER_TOL['blstm_bidi_fwd'] if dtype == BF16 else None)
    row['design'] = DESIGNS['blstm_bidi_fwd'][row['dtype']]
    if dtype == BF16:
        # the first design's kernels on the same work: the one-direction
        # pair's first design for each direction, from the same xg
        G = 4 * H
        row['first_design_ms'] = cuda_ms(lambda: (
            kb._lstm_fwd_first(xg[..., :G], w_hh_t[0], False, False),
            kb._lstm_fwd_first(xg[..., G:], w_hh_t[1], True, False)))
        row['geometry'] = dataclasses.asdict(
            kb._geometry('fwd_xg', B, 8 * H, H, xg.device, 'bidi'))
        row['uni_identical'] = _uni_fwd_bits(xg, w_hh_t, got)
    return row


def _uni_fwd_bits(xg, w_hh_t, got):
    """In bfloat16, ``lstm_fwd`` on each half of the bidi layer's xg (a
    strided view) gives the bidi forward's h and c halves bit for bit: the
    same per-element arithmetic, and an mma column's sum does not depend
    on the row tile. Checks; returns True."""
    G, H = xg.shape[-1] // 2, w_hh_t.shape[1]
    for d in range(2):
        h, c = kb.lstm_fwd(xg[..., d * G:(d + 1) * G], w_hh_t[d],
                           reverse=d == 1, with_cell=True)
        check(torch.equal(h, got[0][..., d * H:(d + 1) * H])
              and torch.equal(c, got[1][..., d * H:(d + 1) * H]),
              f'lstm_fwd direction {d}: h and c the bidi forward\'s halves')
    return True


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


def bwd_bound(rec_flops, grad_flops, nbytes, dtype, split=False):
    """Least time in ms of a backward: the gate recompute's operations run
    on storage-type operands, the gradient products on float32 ones (as in
    the TPU backward), each over its peak; or the bytes over HBM. With
    ``split`` (the fully fused pair's bf16 route) the gradient products run
    as they do there: each f32 operand a two-term bf16 split on the tensor
    cores, twice the operations at the bf16 peak."""
    if split:
        t_ops = (rec_flops + 2 * grad_flops) / PEAK_FLOPS[BF16]
    else:
        t_ops = rec_flops / PEAK_FLOPS[dtype] + grad_flops / PEAK_FLOPS[F32]
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes')


def _bwd_case(name, dtype, run, run_plain, out_names, bound_, library=None,
              library_label='cuDNN backward', split=False, tol=None):
    """Kernel against plain version, each output's error over its peak;
    the plain version is timed once, by the run that gives the reference.
    ``library`` makes the yardstick's call; ``split`` adds one call's device
    time by kernel (:func:`_device_split`); ``tol`` replaces
    ``BWD_RTOL[dtype]``."""
    plain_ms, want = cuda_ms_once(run_plain)
    got = run()
    errs = {}
    for label, g, w in zip(out_names, got, want):
        peak = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        errs[label] = {'max_abs_err': err, 'peak': peak,
                       'rel': err / peak if peak else err}
    rel = max(e['rel'] for e in errs.values())
    tol = BWD_RTOL[dtype] if tol is None else tol
    check(rel <= tol, f'{name} max error over peak {rel:.3g} > {tol}')
    del got, want
    ms = cuda_ms(run)
    library_ms = None
    if library is not None:
        try:
            library_ms = cuda_ms(library())
        except RuntimeError as exc:   # a yardstick only: record its absence
            log(f'{name}: library call refused: {exc}')
    bound_ms, bound_by = bound_
    row = {'name': name, 'dtype': str(dtype).split('.')[-1],
           'max_abs_err': max(e['max_abs_err'] for e in errs.values()),
           'max_rel_err': rel, 'errors': errs, 'ms': ms,
           'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
           'library_ms': library_ms,
           'library': library_label if library else None}
    if split:
        row['device_ms_by_kernel'] = _device_split(run)
    return row


#: The kernels of the CUDA sources, longest name first where one name holds
#: another; the clustered route's products by their operation's name.
_KERNEL_NAMES = ('spill_walk_kernel', 'cell_rebuild_kernel', 'gates_kernel',
                 'blstm_bwd_walk_kernel', 'wgrad_kernel', 'cond_daux_kernel',
                 'cond_dx_kernel', 'dx_kernel', 'blstm_fwd_kernel',
                 *CLUSTER_KERNELS)


def _device_events(prof):
    """(name, device ms) of each kernel a ``torch.profiler`` run recorded."""
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, 'self_device_time_total', None)
        if us is None:
            us = evt.self_cuda_time_total
        yield evt.key, us / 1e3


def _device_split(fn):
    """Device time of one call of ``fn`` by kernel (``_KERNEL_NAMES``, the
    rest as 'other'), from ``torch.profiler``; None where it records none."""
    from torch.profiler import ProfilerActivity, profile
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except (RuntimeError, AttributeError) as exc:
        log(f'profiler failed: {exc}')
        return None
    split = {}
    for key, ms in _device_events(prof):
        name = next((n for n in _KERNEL_NAMES if n in key), 'other')
        split[name] = split.get(name, 0.0) + ms
    return split or None


def _cudnn_bwd(x, dh, H):
    """Yardstick: cuDNN's bidirectional LSTM backward at the shapes of x
    and dh, from a kept graph; returns the call to time."""
    lstm = torch.nn.LSTM(x.shape[-1], H, bidirectional=True,
                         batch_first=True, device='cuda', dtype=x.dtype)
    lstm.flatten_parameters()
    x_leaf = x.detach().requires_grad_()
    out, _ = lstm(x_leaf)
    inputs = [x_leaf, *lstm.parameters()]
    return lambda: torch.autograd.grad(out, inputs, dh, retain_graph=True)


def fullfused_bwd_case(label, B, T, F, H, dtype, gen):
    size = torch.finfo(dtype).bits // 8
    x, w_ih_t, w_hh_t, bias = _fullfused_inputs(B, T, F, H, dtype, gen)
    h, c = kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias, with_cell=True)
    dh = (0.1 * torch.randn(B, T, 2 * H, generator=gen, device='cuda')).to(
        dtype)
    args = (x, w_ih_t, w_hh_t, bias, h, c, dh)
    rows = B * T
    # operations: gate recompute 2 rows 2 dirs (F + H) 4H on storage
    # operands; dh (4H H), weight and bias sums ((F + H + 1) 4H) and dx
    # (4H F) on f32 ones, in bf16 storage each as two bf16 products (the
    # split). bytes: x, h, c, dh and the weights read once, dx and the
    # weight gradients written once (f32).
    rec = 2 * rows * 2 * (F + H) * 4 * H
    grad = 2 * rows * 2 * (4 * H * H + (F + H + 1) * 4 * H + 4 * H * F)
    nbytes = (size * (rows * F + 3 * rows * 2 * H + 2 * (F + H) * 4 * H)
              + 4 * (2 * 4 * H + rows * F + 2 * (F + H + 1) * 4 * H))
    row = _bwd_case(
        f'blstm_fullfused_bwd {label} B={B} T={T} F={F} H={H}', dtype,
        lambda: kb.blstm_fullfused_bwd(*args),
        lambda: kb.blstm_fullfused_bwd_plain(*args),
        ('dx', 'dw_ih', 'dw_hh', 'db'),
        bwd_bound(rec, grad, nbytes, dtype, split=dtype == BF16),
        library=lambda: _cudnn_bwd(x, dh, H), split=label.endswith('birnn0'),
        tol=CLUSTER_TOL['blstm_fullfused_bwd'] if dtype == BF16 else None)
    row['design'] = DESIGNS['blstm_fullfused_bwd'][row['dtype']]
    if dtype == BF16:
        row['parts_ms'] = _bwd_parts_ms(args)
        row['geometry'] = dataclasses.asdict(
            kb._geometry('bwd', B, F, H, x.device))
    return row


def _parts_ms(run, parts):
    """A bf16 backward's launches, each timed alone between CUDA events on
    the same workspace: ``run(bits)`` runs the launches that the bits of
    ``parts`` pick. The walk runs on the gate product's output, which it
    overwrites, so it is timed with that product and the product's time
    taken off; the sums (and dx) run on the walk's output. 'wgrad' holds the
    weight sums' product and, where it cuts the rows into ranges,
    ``splitk_add_kernel``'s sum of their partials."""
    ms = {}
    for name, bit in parts.items():
        if name == 'walk':
            ms[name] = cuda_ms(lambda: run(parts['gates'] | bit)) - ms['gates']
        else:
            ms[name] = cuda_ms(lambda: run(bit))
    return ms


def _bwd_parts_ms(args):
    """The bf16 fully fused backward's four parts (:func:`_parts_ms`)."""
    out = kb._fullfused_bwd_buffers(args[0], args[2].shape[1])
    return _parts_ms(lambda bits: kb._fullfused_bwd_cluster(
        *args, parts=bits, out=out), kb.FULLFUSED_BWD_PARTS)


def spill_bwd_case(label, B, T, F, H, dtype, gen):
    size = torch.finfo(dtype).bits // 8
    x, w_ih_t, w_hh_t, bias = _fullfused_inputs(B, T, F, H, dtype, gen)
    h, cb = kb.blstm_fullfused_spill_fwd(x, w_ih_t, w_hh_t, bias,
                                         with_boundaries=True)
    dh = (0.1 * torch.randn(B, T, 2 * H, generator=gen, device='cuda')).to(
        dtype)
    args = (x, w_ih_t, w_hh_t, bias, h, cb, dh)
    rows = B * T
    # operations: as the fully fused backward's (the gate pre-activations
    # on storage operands; dh, the weight and bias sums and dx on f32 ones,
    # in bf16 storage each as two bf16 products, the split). bytes: x, h,
    # the boundaries, dh and the weights read once, dx and the weight
    # gradients written once (f32).
    rec = 2 * rows * 2 * (F + H) * 4 * H
    grad = 2 * rows * 2 * (4 * H * H + (F + H + 1) * 4 * H + 4 * H * F)
    nbytes = (size * (rows * F + 2 * rows * 2 * H
                      + 2 * -(-T // kb.SPILL_BLOCK) * B * H
                      + 2 * (F + H) * 4 * H)
              + 4 * (2 * 4 * H + rows * F + 2 * (F + H + 1) * 4 * H))
    row = _bwd_case(
        f'blstm_fullfused_spill_bwd {label} B={B} T={T} F={F} H={H}', dtype,
        lambda: kb.blstm_fullfused_spill_bwd(*args),
        lambda: kb.blstm_fullfused_spill_bwd_plain(*args),
        ('dx', 'dw_ih', 'dw_hh', 'db'),
        bwd_bound(rec, grad, nbytes, dtype, split=dtype == BF16),
        library=lambda: _cudnn_bwd(x, dh, H), split=label.endswith('birnn0'),
        tol=CLUSTER_TOL['blstm_fullfused_spill_bwd'] if dtype == BF16
        else None)
    row['design'] = DESIGNS['blstm_fullfused_spill_bwd'][row['dtype']]
    if dtype == BF16:
        out = kb._fullfused_bwd_buffers(x, H)
        row['parts_ms'] = _parts_ms(lambda bits: kb._fullfused_spill_bwd_cluster(
            *args, parts=bits, out=out), kb.SPILL_BWD_PARTS)
        del out
        row['first_design_ms'] = cuda_ms(
            lambda: kb._fullfused_spill_bwd_first(*args))
        # the fully fused backward on the same work, from its forward's h
        # and c (made outside the timed call)
        h_ff, c_ff = kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias,
                                            with_cell=True)
        row['fullfused_ms'] = cuda_ms(lambda: kb.blstm_fullfused_bwd(
            x, w_ih_t, w_hh_t, bias, h_ff, c_ff, dh))
        del h_ff, c_ff
        row['geometry'] = dataclasses.asdict(
            kb._geometry('bwd_spill', B, F, H, x.device, 'spill'))
    return row


def lstm_bwd_case(label, B, T, H, reverse, dtype, gen):
    size = torch.finfo(dtype).bits // 8
    xg = torch.randn(B, T, 4 * H, generator=gen, device='cuda').to(dtype)
    w_hh_t = _uniform(gen, (H, 4 * H), 1 / H ** 0.5, dtype)
    h, c = kb.lstm_fwd(xg, w_hh_t, reverse=reverse, with_cell=True)
    name = (f'lstm_bwd {label} B={B} T={T} H={H} '
            f'{"reverse" if reverse else "forward"}')
    library = _selection_lstm(name, xg, w_hh_t[None], h, dtype,
                              reverse=reverse, ref="the kernel's h")
    dh = 0.1 * torch.randn(B, T, H, generator=gen, device='cuda')
    args = (xg, w_hh_t, h, c, dh)
    rows = B * T
    # operations: gate recompute 2 rows H 4H on storage operands; dh (4H H)
    # and dW_hh (H 4H) on f32 ones. bytes: xg, h, c, w_hh, dh (f32) read
    # once, dxg and dW_hh (f32) written once.
    rec = 2 * rows * H * 4 * H
    grad = 2 * rows * 2 * 4 * H * H
    nbytes = (size * (2 * rows * 4 * H + 2 * rows * H + H * 4 * H)
              + 4 * (rows * H + H * 4 * H))
    row = _bwd_case(
        name, dtype, lambda: kb.lstm_bwd(*args, reverse=reverse),
        lambda: kb.lstm_bwd_plain(*args, reverse=reverse),
        ('dxg', 'dw_hh'),
        bwd_bound(rec, grad, nbytes, dtype, split=dtype == BF16),
        library=lambda: library.backward(dh.to(dtype)),
        library_label=SELECTION_LIBRARY + ', backward',
        tol=CLUSTER_TOL['lstm_bwd'] if dtype == BF16 else None)
    row['design'] = DESIGNS['lstm_bwd'][row['dtype']]
    if dtype == BF16:
        first, again = (kb.lstm_bwd(*args, reverse=reverse) for _ in range(2))
        check(all(torch.equal(f, a) for f, a in zip(first, again)),
              f'{name}: the same bits on two runs')
        row['repeats_bitwise'] = True
        out = kb._lstm_bwd_buffers(xg, H)
        row['parts_ms'] = _parts_ms(lambda bits: kb._lstm_bwd_cluster(
            *args, reverse, parts=bits, out=out), kb.LSTM_BWD_PARTS)
        del out
        row['first_design_ms'] = cuda_ms(
            lambda: kb._lstm_bwd_first(*args, reverse))
        row['geometry'] = dataclasses.asdict(kb._geometry(
            'bwd', B, 4 * H, H, xg.device, 'uni', directions=1))
    return row


def cond_bwd_case(label, B, S, T, F, H, dtype, gen):
    size = torch.finfo(dtype).bits // 8
    inputs = _cond_inputs(B, S, T, F, H, dtype, gen)
    xs, aux = inputs[:2]
    h, c = kb.blstm_fullfused_cond_fwd(*inputs, with_cell=True)
    dh = (0.1 * torch.randn(B, S, T, 2 * H, generator=gen,
                            device='cuda')).to(dtype)
    args = (*inputs, h, c, dh)
    rows = B * S

    def library():
        """Yardstick: the backward of the materialized product and of
        cuDNN's bidirectional LSTM at the same shapes, from a kept graph."""
        lstm = torch.nn.LSTM(F, H, bidirectional=True, batch_first=True,
                             device='cuda', dtype=dtype)
        lstm.flatten_parameters()
        xs_leaf = xs.detach().requires_grad_()
        aux_leaf = aux.detach().requires_grad_()
        out, _ = lstm((xs_leaf[:, None] * aux_leaf[:, :, None]).reshape(
            rows, T, F))
        leaves = [xs_leaf, aux_leaf, *lstm.parameters()]
        dout = dh.reshape(rows, T, 2 * H)
        return lambda: torch.autograd.grad(out, leaves, dout,
                                           retain_graph=True)

    # operations: the fully fused backward's over the B S conditioned rows
    # (gate recompute on storage operands; dh, the weight and bias sums and
    # dcond on f32 ones, in bf16 storage each as two bf16 products, the
    # split) and the split into dx and daux (2 B S T F multiply-adds, f32,
    # priced with them). bytes: xs, aux, h, c, dh and the weights read
    # once; dx, daux and the weight gradients written once (f32).
    rec = 2 * rows * T * 2 * (F + H) * 4 * H
    grad = (2 * rows * T * 2 * (4 * H * H + (F + H + 1) * 4 * H + 4 * H * F)
            + 2 * 2 * rows * T * F)
    nbytes = (size * (B * T * F + rows * F + 3 * rows * T * 2 * H
                      + 2 * (F + H) * 4 * H)
              + 4 * (2 * 4 * H + B * T * F + rows * F
                     + 2 * (F + H + 1) * 4 * H))
    row = _bwd_case(
        f'blstm_fullfused_cond_bwd {label} B={B} S={S} T={T} F={F} H={H}',
        dtype, lambda: kb.blstm_fullfused_cond_bwd(*args),
        lambda: kb.blstm_fullfused_cond_bwd_plain(*args),
        ('dx', 'daux', 'dw_ih', 'dw_hh', 'db'),
        bwd_bound(rec, grad, nbytes, dtype, split=dtype == BF16),
        library=library, library_label=COND_LIBRARY,
        tol=CLUSTER_TOL['blstm_fullfused_cond_bwd'] if dtype == BF16
        else None)
    row['design'] = DESIGNS['blstm_fullfused_cond_bwd'][row['dtype']]
    if dtype == BF16:
        out = kb._cond_bwd_buffers(xs, S, H)
        row['parts_ms'] = _parts_ms(
            lambda bits: kb._fullfused_cond_bwd_cluster(*args, parts=bits,
                                                        out=out),
            kb.COND_BWD_PARTS)
        row['first_design_ms'] = cuda_ms(
            lambda: kb._fullfused_cond_bwd_first(*args))
        row['materialized_ms'], row['fullfused_ms'] = (
            _cond_materialized_bwd_ms(args))
        row['geometry'] = dataclasses.asdict(
            kb._geometry('bwd', rows, F, H, xs.device))
    return row


def _cond_materialized_bwd_ms(args):
    """The default model's route on the conditioned backward's work: the
    clustered fully fused backward at B S rows over the materialized product
    (made, with its forward's h and c, outside the timed call), then the
    product's backward, dx and daux as autograd forms them in the storage
    type; and that kernel alone."""
    xs, aux, w_ih_t, w_hh_t, bias, _, _, dh = args
    B, S, T, F = *aux.shape[:2], *xs.shape[1:]
    x = _materialized(xs, aux)
    h, c = kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias, with_cell=True)
    dh = dh.reshape(B * S, T, -1)

    def kernel():
        return kb.blstm_fullfused_bwd(x, w_ih_t, w_hh_t, bias, h, c, dh)[0]

    def run():
        dx = kernel().to(xs.dtype).view(B, S, T, F)
        return (dx * aux[:, :, None]).sum(dim=1), (dx * xs[:, None]).sum(
            dim=2)

    return cuda_ms(run), cuda_ms(kernel)


def bidi_bwd_case(label, B, T, H, dtype, gen):
    size = torch.finfo(dtype).bits // 8
    xg = torch.randn(B, T, 8 * H, generator=gen, device='cuda').to(dtype)
    w_hh_t = _uniform(gen, (2, H, 4 * H), 1 / H ** 0.5, dtype)
    h, c = kb.blstm_bidi_fwd(xg, w_hh_t, with_cell=True)
    dh = 0.1 * torch.randn(B, T, 2 * H, generator=gen, device='cuda')
    args = (xg, w_hh_t, h, c, dh)
    rows = B * T
    name = f'blstm_bidi_bwd {label} B={B} T={T} H={H}'
    library = _selection_lstm(name, xg, w_hh_t, h, dtype,
                              ref="the kernel's h")
    # operations: gate recompute 2 rows 2 dirs H 4H on storage operands;
    # dh (4H H) and dW_hh (H 4H) on f32 ones, in bf16 storage each as two
    # bf16 products (the split). bytes: xg, h, c, w_hh, dh (f32) read once,
    # dxg and dW_hh (f32) written once.
    rec = 2 * rows * 2 * H * 4 * H
    grad = 2 * rows * 2 * 2 * 4 * H * H
    nbytes = (size * (2 * rows * 8 * H + 2 * rows * 2 * H + 2 * H * 4 * H)
              + 4 * (rows * 2 * H + 2 * H * 4 * H))
    row = _bwd_case(
        name, dtype, lambda: kb.blstm_bidi_bwd(*args),
        lambda: kb.blstm_bidi_bwd_plain(*args),
        ('dxg', 'dw_hh'),
        bwd_bound(rec, grad, nbytes, dtype, split=dtype == BF16),
        library=lambda: library.backward(dh.to(dtype)),
        library_label=SELECTION_LIBRARY + ', backward',
        tol=CLUSTER_TOL['blstm_bidi_bwd'] if dtype == BF16 else None)
    row['design'] = DESIGNS['blstm_bidi_bwd'][row['dtype']]
    if dtype == BF16:
        row['parts_ms'] = _bidi_bwd_parts_ms(args)
        row['first_design_ms'] = _bidi_bwd_first_design_ms(args)
        row['uni_identical'] = _uni_bwd_bits(args)
        row['geometry'] = dataclasses.asdict(
            kb._geometry('bwd', B, 8 * H, H, xg.device, 'bidi'))
    return row


def _bidi_bwd_parts_ms(args):
    """The bf16 bidi backward's three parts (:func:`_parts_ms`)."""
    out = kb._bidi_bwd_buffers(args[0], args[1].shape[1])
    return _parts_ms(lambda bits: kb._bidi_bwd_cluster(
        *args, parts=bits, out=out), kb.BIDI_BWD_PARTS)


def _directions_of(args):
    """The one-direction pair's arguments for each direction of a bidi
    backward's (each direction's h and c made contiguous, as those kernels
    read them; xg and dh strided views)."""
    xg, w_hh_t, h, c, dh = args
    G, H = xg.shape[-1] // 2, w_hh_t.shape[1]
    return [(xg[..., d * G:(d + 1) * G], w_hh_t[d],
             h[..., d * H:(d + 1) * H].contiguous(),
             c[..., d * H:(d + 1) * H].contiguous(),
             dh[..., d * H:(d + 1) * H]) for d in range(2)]


def _bidi_bwd_first_design_ms(args):
    """The first design's kernels on the same work: the one-direction
    pair's first design for each direction (its inputs made outside the
    timed calls)."""
    dirs = _directions_of(args)
    return cuda_ms(lambda: [kb._lstm_bwd_first(*a, d == 1)
                            for d, a in enumerate(dirs)])


def _uni_bwd_bits(args):
    """In bfloat16, ``lstm_bwd`` on each direction of a bidi backward's
    work gives the bidi backward's dxg halves bit for bit, and dW_hh^T
    within ``CLUSTER_TOL`` of its own (bit for bit only where the weight
    sums cut the rows alike). Checks; returns True."""
    dxg2, dw2 = kb.blstm_bidi_bwd(*args)
    G = dxg2.shape[-1] // 2
    for d, a in enumerate(_directions_of(args)):
        dxg, dw = kb.lstm_bwd(*a, reverse=d == 1)
        check(torch.equal(dxg, dxg2[..., d * G:(d + 1) * G]),
              f'lstm_bwd direction {d}: dxg the bidi backward\'s half')
        rel = ((dw - dw2[d]).abs().max() / dw2[d].abs().max()).item()
        check(rel <= CLUSTER_TOL['lstm_bwd'],
              f'lstm_bwd direction {d}: dW_hh^T against the bidi backward\'s '
              f'{rel:.3g}')
    return True


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)
    rows = {name: [] for name in KERNELS}
    plan = [('blstm_fullfused_fwd', fullfused_case, FULLFUSED_CASES),
            ('blstm_bidi_fwd', bidi_case, BIDI_CASES),
            ('blstm_fullfused_bwd', fullfused_bwd_case, FULLFUSED_BWD_CASES),
            ('blstm_bidi_bwd', bidi_bwd_case, BIDI_BWD_CASES),
            ('blstm_fullfused_cond_fwd', cond_case, COND_CASES),
            ('blstm_fullfused_cond_bwd', cond_bwd_case, COND_BWD_CASES),
            ('blstm_fullfused_spill_fwd', spill_case, SPILL_CASES),
            ('blstm_fullfused_spill_bwd', spill_bwd_case, SPILL_BWD_CASES),
            ('lstm_fwd', lstm_case, LSTM_CASES),
            ('lstm_bwd', lstm_bwd_case, LSTM_BWD_CASES)]
    for dtype in (F32, BF16):
        for name, case_fn, cases in plan:
            for case in cases:
                # graphs only for the backward cases' cuDNN yardstick
                with torch.set_grad_enabled(name.endswith('_bwd')):
                    rows[name].append(case_fn(*case, dtype, gen))
                log(json.dumps(rows[name][-1]))
                torch.cuda.empty_cache()
    return rows


def make_request(gen, batch, channels=1):
    """One request in ``DeviceMeetingSimulator.generate``'s layout."""
    return {
        'observation': 0.1 * torch.randn(batch, channels, SAMPLES,
                                         generator=gen, device='cuda'),
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


def _agreement(model, ex, dtype, reference=None, what='plain versions'):
    """Masks and waveforms of ``model`` against ``reference`` on ``ex``:
    the same model through the plain versions unless ``reference`` is
    another model."""
    got = model(ex)
    want = (_plain_forward(model, ex) if reference is None
            else reference(ex))
    mask_err = (got.mask - want.mask).abs().max().item()
    peak = want.time_estimate.abs().max().item()
    wave_err = (got.time_estimate - want.time_estimate).abs().max().item() / peak
    log(f'serve {dtype}: kernels against {what}: mask max abs err '
        f'{mask_err:.3g}, waveform max abs err / peak {wave_err:.3g} '
        f'(tolerance {SERVE_ATOL[dtype]})')
    check(mask_err <= SERVE_ATOL[dtype], f'{dtype} served masks ({what})')
    check(wave_err <= SERVE_ATOL[dtype], f'{dtype} served waveforms ({what})')
    return {'mask_err': mask_err, 'wave_err': wave_err}


def _flagship(storage_dtype=BF16, trials=1, **switches):
    """The flagship model with random weights from seed 0."""
    return _model(dict(FLAGSHIP, mask_estimator=dict(
        FLAGSHIP['mask_estimator'], num_averaged_permutations=trials)),
        storage_dtype, **switches)


def _model(cfg, storage_dtype=BF16, **switches):
    """The model of ``cfg`` with random weights from seed 0."""
    model = Model.from_config(cfg, storage_dtype=storage_dtype,
                              device='cuda', **switches)
    return model.init_params(torch.Generator().manual_seed(0))


def _serve(model, requests):
    """Serves ``requests`` with the launch counts set to 0 just before;
    checks every output. Returns (ms per request, launches)."""
    _reset_launches()
    times = []
    for ex in requests:
        t0 = time.perf_counter()
        out = model(ex)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        nmask = model.mask_estimator.nmask
        check(out.mask.shape == (SERVE_BATCH, SPEAKERS, nmask, FRAMES, BINS),
              f'mask shape {tuple(out.mask.shape)}')
        check(out.time_estimate.shape == (SERVE_BATCH, SPEAKERS, SAMPLES),
              f'waveform shape {tuple(out.time_estimate.shape)}')
        check(bool(torch.isfinite(out.mask).all()), 'finite masks')
        check(bool(torch.isfinite(out.time_estimate).all()),
              'finite waveforms')
    return times, _launches()


def _expect(per_run, runs):
    """Launch counts of ``runs`` runs: ``per_run`` per run, 0 elsewhere."""
    return {name: runs * per_run.get(name, 0) for name in KERNELS}


def _peak_mib(fn):
    """Peak memory of ``fn()`` over what was allocated before, in MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 2 ** 20


def _requests(channels=1):
    """A warm-up request and ``REQUESTS`` requests, the same every call."""
    gen = torch.Generator(device='cuda').manual_seed(1)
    return [make_request(gen, SERVE_BATCH, channels)
            for _ in range(1 + REQUESTS)]


def phase_serving():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _flagship()
    warm, *requests = _requests()
    model(warm)
    torch.cuda.synchronize()

    times, launches = _serve(model, requests)
    log(f'serve: {REQUESTS} requests of batch {SERVE_BATCH}, ms each '
        f'{[round(t, 2) for t in times]}, launches {launches}')
    check(launches == _expect({'blstm_fullfused_fwd': 3,
                               'blstm_bidi_fwd': 1}, REQUESTS),
          f'3 fully fused and 1 bidi launch per request, got {launches}')

    _agreement(model, requests[0], BF16)
    model32 = _flagship(F32)
    _agreement(model32, requests[0], F32)
    return launches


def phase_serving_cond():
    """``cond_fuse`` served as :func:`phase_serving_switch` serves a switch,
    then 1 request at 2 permutation trials against the model without it and
    the plain versions."""
    per_request = {'blstm_fullfused_cond_fwd': 1, 'blstm_fullfused_fwd': 2,
                   'blstm_bidi_fwd': 1}
    result = phase_serving_switch('serve cond_fuse', per_request,
                                  cond_fuse=True)
    warm, *requests = _requests()
    model2, base2 = (_flagship(trials=2, cond_fuse=True),
                     _flagship(trials=2))
    model2(warm)
    times2, launches2 = _serve(model2, requests[:1])
    log(f'serve cond_fuse trials 2: 1 request of batch {SERVE_BATCH}, ms '
        f'{[round(t, 2) for t in times2]}, launches {launches2}')
    check(launches2 == _expect(per_request, 1),
          f'trials 2: per request {per_request}, got {launches2}')
    agree = result['agreement']
    agree['trials 2 default'] = _agreement(
        model2, requests[0], BF16, base2, 'the default model, trials 2')
    agree['trials 2 plain'] = _agreement(model2, requests[0], BF16)
    return dict(result, launches_trials2=launches2, ms_trials2=times2)


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


def _train_agreement(model, batch, dtype, reference=None,
                     what='plain versions'):
    """One step's loss and gradients of ``model`` against the same model
    through the plain versions, or against ``reference``, another model,
    through the kernels."""
    loss, grads = _step_grads(model, batch, plain=False)
    loss_plain, grads_plain = (
        _step_grads(model, batch, plain=True) if reference is None
        else _step_grads(reference, batch, plain=False))
    rel = {n: ((grads[n] - g).abs().max()
               / g.abs().max().clamp(min=1e-30)).item()
           for n, g in grads_plain.items()}
    worst = max(rel, key=rel.get)
    log(f'train {dtype}: kernels against {what}: loss {loss:.6f} '
        f'vs {loss_plain:.6f}, gradients max abs err / max abs over '
        f'{len(rel)} parameters {rel[worst]:.3g} ({worst}) (tolerance '
        f'{TRAIN_TOL[dtype]})')
    check(abs(loss - loss_plain) <= TRAIN_TOL[dtype],
          f'{dtype} step loss ({what})')
    check(rel[worst] <= TRAIN_TOL[dtype], f'{dtype} step gradients ({what})')
    return {'loss': loss, 'loss_plain': loss_plain,
            'max_rel_grad_err': rel[worst], 'worst_param': worst}


_STEP_KERNELS = {'forward kernels': ('blstm_fwd_kernel', 'cluster_fwd_kernel'),
                 'backward kernels': ('blstm_bwd_walk_kernel', 'wgrad_kernel',
                                      'dx_kernel', 'cond_daux_kernel',
                                      'cond_dx_kernel', 'gates_kernel',
                                      'cell_rebuild_kernel',
                                      'spill_walk_kernel',
                                      'cluster_walk_kernel', 'tc_gemm_kernel',
                                      'splitk_add_kernel')}


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
    for key, ms in _device_events(prof):
        group = next((g for g, names in _STEP_KERNELS.items()
                      if any(n in key for n in names)),
                     'other device work')
        split[group] += ms
    busy = sum(split.values())
    if busy == 0:
        return None
    split['device idle'] = wall_ms - busy
    split['wall (profiled)'] = wall_ms
    return split


def _train(model, steps, per_step, label):
    """``Trainer.train`` for ``steps`` steps of batch ``TRAIN_BATCH`` on the
    simulator's batches, with the launch counts set to 0 just before; checks
    the losses and that each step launched ``per_step``."""
    sim = DeviceMeetingSimulator(duration=SAMPLES / 16000,
                                 num_speakers=SPEAKERS, aux_size=BINS)
    data = DeviceSimDataset(sim, TRAIN_BATCH, seed=2,
                            targets=model.loss.device_targets() | {'Vad'},
                            device='cuda')
    trainer = Trainer(model, Adam(gradient_clipping=10, lr=1e-3), seed=0)

    _reset_launches()
    t0 = time.perf_counter()
    losses = trainer.train(data, steps)
    train_s = time.perf_counter() - t0
    launches = _launches()
    log(f'{label}: Trainer.train {steps} steps of batch {TRAIN_BATCH} '
        f'in {train_s:.2f} s (first calls included), losses {losses}, '
        f'launches {launches}')
    check(len(losses) == steps, f'{label}: a loss per step')
    check(all(map(math.isfinite, losses)), f'{label}: finite losses')
    check(launches == _expect(per_step, steps),
          f'{label}: per step {per_step}, got {launches}')
    return trainer, data, losses, launches


def _step_times(trainer, data, steps, label):
    """Steady-state steps on fresh batches: the batch's generation and the
    step are timed apart, each ending in a synchronize."""
    it = iter(data)
    gen_ms, step_ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch = next(it)
        torch.cuda.synchronize()
        gen_ms.append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
    log(f'{label}: step ms {[round(t, 2) for t in step_ms]}, batch '
        f'generation ms {[round(t, 2) for t in gen_ms]}')
    return gen_ms, step_ms, batch


def phase_training(rows):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _flagship()
    trainer, data, losses, launches = _train(
        model, TRAIN_STEPS, {'blstm_fullfused_fwd': 3, 'blstm_bidi_fwd': 1,
                             'blstm_fullfused_bwd': 3, 'blstm_bidi_bwd': 1},
        'train')
    gen_ms, step_ms, batch = _step_times(trainer, data, TRAIN_STEPS, 'train')

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

    agree = _train_checks(model, batch, 'train')
    return {'launches': launches, 'losses': losses, 'step_ms': step_ms,
            'gen_ms': gen_ms, 'split_estimate': est, 'split_profiler': split,
            'agreement': agree}


def _train_checks(model, batch, label, cfg=FLAGSHIP, **switches):
    """One step's loss and gradients against the plain versions, in
    bfloat16 and in float32 storage, on ``model``'s current weights."""
    agree = {'bfloat16': _train_agreement(model, batch, BF16)}
    model32 = _model(cfg, F32, **switches)
    model32.load_state_dict(model.state_dict())
    agree['float32'] = _train_agreement(model32, batch, F32)
    log(f'{label}: one step against the plain versions agrees')
    return agree


def phase_serving_switch(label, per_request, identical=False, **switches):
    """Serving with ``switches``: ``REQUESTS`` requests of the same weights
    and requests as the default, through the kernels ``per_request`` names;
    masks and waveforms against the default model (with ``identical``, bit
    for bit) and the plain versions; the peak memory of one request with
    and without the switches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, base = _flagship(**switches), _flagship()
    warm, *requests = _requests()
    model(warm)
    torch.cuda.synchronize()

    times, launches = _serve(model, requests)
    log(f'{label}: {REQUESTS} requests of batch {SERVE_BATCH}, ms each '
        f'{[round(t, 2) for t in times]}, launches {launches}')
    check(launches == _expect(per_request, REQUESTS),
          f'{label}: per request {per_request}, got {launches}')
    agree = {'default': _agreement(model, requests[0], BF16, base,
                                   'the default model'),
             'plain': _agreement(model, requests[0], BF16),
             'plain f32': _agreement(_flagship(F32, **switches), requests[0],
                                     F32)}
    if identical:
        for ex in requests:
            got, want = model(ex), base(ex)
            check(torch.equal(got.mask, want.mask)
                  and torch.equal(got.time_estimate, want.time_estimate),
                  f'{label}: masks and waveforms bit for bit the default '
                  f'model\'s')
        agree['default bit for bit'] = True
        log(f'{label}: masks and waveforms of {REQUESTS} requests bit for '
            f'bit the default model\'s')
    peak = {'switched': _peak_mib(lambda: model(requests[0])),
            'default': _peak_mib(lambda: base(requests[0]))}
    log(f'{label}: peak memory of one request of batch {SERVE_BATCH} over '
        f'the weights (MiB): {json.dumps(peak)}')
    return {'launches': launches, 'ms': times, 'peak_mib': peak,
            'agreement': agree}


def phase_training_switch(label, steps, per_step, **switches):
    """Training with ``switches``: ``steps`` steps through the kernels
    ``per_step`` names, one step's loss and gradients against the plain
    versions and against the default model on the same weights, and the
    peak memory of one step with and without the switches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _flagship(**switches)
    trainer, data, losses, launches = _train(model, steps, per_step, label)
    gen_ms, step_ms, batch = _step_times(trainer, data, steps, label)
    try:
        split = _profile_step(trainer, batch)
    except (RuntimeError, AttributeError) as exc:
        split = None
        log(f'{label}: profiler failed: {exc}')
    log(f'{label}: step split from torch.profiler (ms): '
        f'{json.dumps(split) if split else "not measured"}')
    agree = _train_checks(model, batch, label, **switches)
    base = _flagship()
    base.load_state_dict(model.state_dict())
    agree['default'] = _train_agreement(model, batch, BF16, base,
                                        'the default model')
    peak = {'switched': _peak_mib(lambda: _step_grads(model, batch, False)),
            'default': _peak_mib(lambda: _step_grads(base, batch, False))}
    log(f'{label}: peak memory of one step\'s forward and backward at batch '
        f'{TRAIN_BATCH} over the weights (MiB): {json.dumps(peak)}')
    return {'launches': launches, 'losses': losses, 'step_ms': step_ms,
            'gen_ms': gen_ms, 'split_profiler': split, 'peak_mib': peak,
            'agreement': agree}


#: Launches of one served request or training step of the default path
#: (the flagship's, the recipe's stages', the MVDR model's): pre_net, birnn0
#: and birnn1 fully fused (at the recipe's 2 trials birnn0 and birnn1 on
#: twice the rows), the stacked birnn2 through the bidi pair.
PER_REQUEST = {'blstm_fullfused_fwd': 3, 'blstm_bidi_fwd': 1}
PER_STEP = dict(PER_REQUEST, blstm_fullfused_bwd=3, blstm_bidi_bwd=1)


def phase_serving_model(label, cfg, per_request, channels=1):
    """``cfg``'s model serves ``REQUESTS`` requests of batch 16 through the
    kernels ``per_request`` names, its masks and waveforms against the plain
    versions in bfloat16 and float32 storage; the peak memory of one
    request."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _model(cfg)
    warm, *requests = _requests(channels)
    model(warm)
    torch.cuda.synchronize()
    times, launches = _serve(model, requests)
    log(f'{label}: {REQUESTS} requests of batch {SERVE_BATCH}, '
        f'{channels} channel(s), ms each {[round(t, 2) for t in times]}, '
        f'launches {launches}')
    check(launches == _expect(per_request, REQUESTS),
          f'{label}: per request {per_request}, got {launches}')
    agree = {'plain': _agreement(model, requests[0], BF16),
             'plain f32': _agreement(_model(cfg, F32), requests[0], F32)}
    peak = _peak_mib(lambda: model(requests[0]))
    log(f'{label}: peak memory of one request of batch {SERVE_BATCH} over '
        f'the weights (MiB): {peak:.2f}')
    return {'launches': launches, 'ms': times, 'peak_mib': peak,
            'agreement': agree}


def phase_training_model(label, cfg, per_step):
    """``cfg``'s model trains ``TRAIN_STEPS`` steps at batch 16 on the
    simulator's batches through the kernels ``per_step`` names; one profiled
    step; one step's loss and gradients against the plain versions; the
    peak memory of one step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _model(cfg)
    trainer, data, losses, launches = _train(model, TRAIN_STEPS, per_step,
                                             label)
    gen_ms, step_ms, batch = _step_times(trainer, data, TRAIN_STEPS, label)
    try:
        split = _profile_step(trainer, batch)
    except (RuntimeError, AttributeError) as exc:
        split = None
        log(f'{label}: profiler failed: {exc}')
    log(f'{label}: step split from torch.profiler (ms): '
        f'{json.dumps(split) if split else "not measured"}')
    agree = _train_checks(model, batch, label, cfg=cfg)
    peak = _peak_mib(lambda: _step_grads(model, batch, False))
    log(f'{label}: peak memory of one step\'s forward and backward at batch '
        f'{TRAIN_BATCH} over the weights (MiB): {peak:.2f}')
    return {'launches': launches, 'losses': losses, 'step_ms': step_ms,
            'gen_ms': gen_ms, 'split_profiler': split, 'peak_mib': peak,
            'agreement': agree}


def pair_summary(switch, pair, rows, serving, training):
    """Logs a redesigned pair in bfloat16 at batch 16: each kernel's
    numbers, summed over its calls on a served request (forward) or a
    training step (backward), beside its first design, the route it is
    compared with and the cuDNN yardstick, and the times and peak memory of
    serving and training with ``switch``."""
    keys = ('ms', 'bound_ms', 'first_design_ms', 'materialized_ms',
            'fullfused_ms', 'library_ms', 'parts_ms')
    out = {}
    for name, tag in zip(pair, (' serve ', ' train ')):
        path = [r for r in rows[name]
                if tag in r['name'] and r['dtype'] == 'bfloat16']
        out[name] = {k: sum(r[k] for r in path) for k in keys
                     if all(r.get(k) is not None for r in path)
                     and k != 'parts_ms'}
        if all('parts_ms' in r for r in path):
            out[name]['parts_ms'] = {
                part: sum(r['parts_ms'][part] for r in path)
                for part in path[0]['parts_ms']}
    out[f'serve {switch}'] = {'ms': serving['ms'],
                              'peak_mib': serving['peak_mib']}
    out[f'train {switch}'] = {'step_ms': training['step_ms'],
                              'peak_mib': training['peak_mib']}
    log(f'{switch} (bf16, batch 16): {json.dumps(out)}')


def kernels_line(rows, phase_launches):
    """Per kernel: the numbers of one served request (forward kernels) or
    one training step (backward kernels) at batch 16 in bfloat16 storage,
    summed over its calls on that path; the launches of the main path's
    runs, in all and by phase; and every call measured."""
    kernels = []
    for name, calls in rows.items():
        tag = ' serve ' if name.endswith('_fwd') else ' train '
        path = [r for r in calls if tag in r['name']
                and r['dtype'] == 'bfloat16']
        top = max(path, key=lambda r: r['bound_ms'])
        lib = [r['library_ms'] for r in path]
        extra = {}
        if name in DESIGNS:
            extra['design'] = DESIGNS[name]
        if all('first_design_ms' in r for r in path):
            extra['first_design_ms'] = sum(r['first_design_ms']
                                           for r in path)
        for key in ('materialized_ms', 'fullfused_ms'):
            if all(key in r for r in path):
                extra[key] = sum(r[key] for r in path)
        if all('parts_ms' in r for r in path):
            extra['parts_ms'] = {part: sum(r['parts_ms'][part] for r in path)
                                 for part in path[0]['parts_ms']}
        kernels.append({
            'name': name, 'route': 'cuda', 'source': SOURCES[name][0],
            'replaces': SOURCES[name][1],
            'launches': sum(p[name] for p in phase_launches.values()),
            'launches_by_phase': {phase: p[name] for phase, p in
                                  phase_launches.items()},
            'max_abs_err': max(r['max_abs_err'] for r in path),
            'ms': sum(r['ms'] for r in path),
            'plain_ms': sum(r['plain_ms'] for r in path),
            'bound_ms': sum(r['bound_ms'] for r in path),
            'bound_by': top['bound_by'],
            'library_ms': None if None in lib else sum(lib),
            'library': top['library'],
            **extra,
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
    serving_cond = phase_serving_cond()
    log(f'-- serving cond_fuse done at {time.perf_counter() - t0:.1f} s')
    training = phase_training(rows)
    log(f'-- training done at {time.perf_counter() - t0:.1f} s')
    switched = {}
    for label, run in (
            ('train cond_fuse', lambda label: phase_training_switch(
                label, TRAIN_STEPS, {
                    'blstm_fullfused_cond_fwd': 1,
                    'blstm_fullfused_cond_bwd': 1, 'blstm_fullfused_fwd': 2,
                    'blstm_fullfused_bwd': 2, 'blstm_bidi_fwd': 1,
                    'blstm_bidi_bwd': 1}, cond_fuse=True)),
            ('train fullfuse=False', lambda label: phase_training_switch(
                label, 2, {'blstm_bidi_fwd': 4, 'blstm_bidi_bwd': 4},
                fullfuse=False)),
            ('serve spill', lambda label: phase_serving_switch(
                label, {'blstm_fullfused_spill_fwd': 3, 'blstm_bidi_fwd': 1},
                identical=True, spill=True)),
            ('serve bidi=False', lambda label: phase_serving_switch(
                label, {'blstm_fullfused_fwd': 3, 'lstm_fwd': 2},
                bidi=False)),
            ('train spill', lambda label: phase_training_switch(
                label, TRAIN_STEPS, {
                    'blstm_fullfused_spill_fwd': 3,
                    'blstm_fullfused_spill_bwd': 3, 'blstm_bidi_fwd': 1,
                    'blstm_bidi_bwd': 1}, spill=True)),
            ('train bidi=False', lambda label: phase_training_switch(
                label, TRAIN_STEPS, {
                    'blstm_fullfused_fwd': 3, 'blstm_fullfused_bwd': 3,
                    'lstm_fwd': 2, 'lstm_bwd': 2}, bidi=False)),
            ('train fullfuse=False bidi=False',
             lambda label: phase_training_switch(
                 label, 2, {'lstm_fwd': 8, 'lstm_bwd': 8}, fullfuse=False,
                 bidi=False))):
        switched[label] = run(label)
        log(f'-- {label} done at {time.perf_counter() - t0:.1f} s')
    for label, run in (
            ('serve tsvad', lambda label: phase_serving_model(
                label, TSVAD, PER_REQUEST)),
            ('train tsvad', lambda label: phase_training_model(
                label, TSVAD, PER_STEP)),
            ('serve tssep recipe', lambda label: phase_serving_model(
                label, TSSEP_RECIPE, PER_REQUEST)),
            ('serve mvdr', lambda label: phase_serving_model(
                label, MVDR, PER_REQUEST, MVDR_CHANNELS))):
        switched[label] = run(label)
        log(f'-- {label} done at {time.perf_counter() - t0:.1f} s')
    log(json.dumps({'serving cond_fuse': serving_cond, 'training': training,
                    **switched}))
    pair_summary('cond_fuse', ('blstm_fullfused_cond_fwd',
                               'blstm_fullfused_cond_bwd'), rows,
                 serving_cond, switched['train cond_fuse'])
    pair_summary('spill', ('blstm_fullfused_spill_fwd',
                           'blstm_fullfused_spill_bwd'), rows,
                 switched['serve spill'], switched['train spill'])
    pair_summary('bidi=False', ('lstm_fwd', 'lstm_bwd'), rows,
                 switched['serve bidi=False'], switched['train bidi=False'])
    print(json.dumps(kernels_line(rows, {
        'serve': serve_launches,
        'serve cond_fuse': serving_cond['launches'],
        'serve cond_fuse trials 2': serving_cond['launches_trials2'],
        'train': training['launches'],
        **{label: r['launches'] for label, r in switched.items()}})))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
