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
   batch-256 ``pre_net`` row), and at the recipe's own widths (H 40: 1 row
   at F 553, 16 rows at F 513 and 42, 2 and 16 rows at F 336; clusters of
   8 CTAs with 5 active). Every pair runs, in bfloat16, the
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
   port's on-device simulator (``Trainer.train_steps``, LogMAE, clipped
   Adam),
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
    on requests of 7 channels;
17. recipe cli: the toy recipe's two stages through the port's CLI
    (``tssep_tpu_torch.train.run.main``, in this process so that the launch
    counters see its kernels) in a temporary directory, at the YAML's widths
    (units 40, projs 42) in float32, the CLI's default: TS-VAD for 400
    iterations with checkpoints and validation (its ``test_run``
    pre-flight included), then TS-SEP warm-started from TS-VAD's
    ``ckpt_best_loss.npz`` and cold-started, 20 iterations each; the
    storage dirs' files, the launch counts (the fully fused pair only), ms
    per iteration, the time to checkpoint and to validate, a profiled step
    with the device's idle share, and the zero-shot validation loss and
    SI-SDR gain over the mixture of the warm and the cold TS-SEP, which
    the warm one must win;
18. recipe cli flagship: TS-VAD through the CLI at the flagship's widths
    (units 300, projs 320) in bfloat16 for 12 iterations: the stacked
    birnn2 (2560 wide) adds the bidi pair;
19. eval flagship: the flagship (bf16) evaluates a 60 s recording of 7
    channels and 8 speakers (``DummyReader``'s generator stretched, seed 0)
    through ``tssep_tpu_torch.eval.driver.EvalDriver``: chunks of 316
    frames every 158, 8 a forward call (``pre_net`` and ``birnn2`` on 8 rows,
    ``birnn0``/``birnn1`` on 64), once with ``ClassicBF`` (MVDR) and once
    with masking: the chunk count, 3 fully fused and 1 bidi launch per
    call, masks and activity against the plain versions in bf16 and f32
    storage and the diarized frames that differ, the ms per stage (STFT,
    features, chunked forward with its host copies, stitching, diarization,
    enhancer, ISTFT, DER), seconds per second of audio, the segments and
    speaker-frames the enhancer covered, the MVDR timed again with those
    masks on the recording's reference diarization, the peak memory;
    ``ClassicBF`` with WPE on the card (``backend='torch'``, float64)
    against numpy on a reverberant 7-channel mixture of 10 s;
20. eval cli: ``tssep_tpu_torch.eval.run.main`` (in this process) on phase
    17's warm-started toy TS-SEP storage dir, f32: masking on 1 channel,
    then the MVDR on 7 (``eg.trainer.model.reader.num_channels=7
    beamform=true``); each writes ``metrics.json`` with a calibration
    without error, finite mean DER and SI-SDR, segments on every recording
    and WAVs from the native writer;
21. recipe simulated: the simulated-corpus recipe
    (``tssep_tpu_torch.exp.run_simulated.main_multichannel``, in this
    process) at the R5W widths (units/projs 64, F 513, 'gate' aux 513, 6
    channels, reverb taps 2, a pool of 16 voices, batch 8, 2 trials,
    ``explicit_vad``, ``vad_weight`` 0.3, a vocabulary of 8 words; the
    stages in bf16, the CTC recognizer in f32), its depth cut to 32
    training meetings, 2 eval recordings, 40 TS-VAD and 20 TS-SEP
    iterations and 60 CTC steps, in a temporary work dir: the shards the
    native writer wrote, read back with their example counts; the CTC
    loss finite and falling; both stages' losses finite; the fully fused
    pair launched in the CTC training and in each stage, its forward in
    each of the five evaluations, which return their recordings, a finite
    DER, segments and a cpWER, and an SI-SDR or the reasons it has none;
    the simulation's seconds, ms a CTC step, ms a TS-VAD and a TS-SEP
    step and iteration (12 steps of 8 meetings: the Experiment's virtual
    minibatch), each evaluation's seconds a recording and the
    transcription's share, the launches and the peak memory; then the
    fully fused pair against its plain versions at each (rows, F, H) the
    phase launched (bf16, H 64, to ``CLUSTER_TOL``; f32, H 48, to the f32
    gates), and at the CTC's training and transcription shapes;
22. serve streaming: ``tssep_tpu_torch.eval.streaming.StreamingSession`` on
    the flagship (bf16, bf16 head) over one 60 s stream at 16 kHz fed in
    blocks of 4,000 samples, chunks of 50 frames and 12 of lookahead, audio
    emitted: ms a chunk (p50, p95, max), the real-time factor, the
    ``lstm_fwd`` launches (3 a layer and block from a carried state, 12 a
    block; nothing else), the peak memory; the first 10 s against the plain
    versions, a covering lookahead in f32 against ``Model.forward`` on the
    same causal frames, and the Kaldi-input TS-VAD model
    (``tests/test_kaldi.py:113-141``, its MFCC made on the card) served
    against the plain versions in bf16 and f32. The kernels phase holds
    ``lstm_fwd`` from a nonzero carried state against its plain version at
    the session's shapes (rows 1 and 8, T 12, 50 and 62), in f32 and bf16,
    beside cuDNN's LSTM from the same state;
23. distributed: data parallelism on ``torch.distributed``
    (``tssep_tpu_torch/dist``) at the flagship's width (bf16, bf16 head),
    batch 16 on the simulator's batches. (a) One NCCL rank in this process:
    ``Trainer(mesh={'data': 1})`` trains 3 steps through the kernels (the
    launch counts) and equals the run without a mesh bit for bit; (b) two
    ranks share the card (the spawn method, gloo: NCCL takes one rank a
    device), each with its 8 rows of every global batch of 16, equal the
    same two batches of 8 run in one process bit for bit, and agree with
    the one-process run at batch 16 (bf16: losses at rtol 1e-3, parameters
    at JAX's rtol 2e-2 / atol 3e-3); (c) the two ranks deal the chunks of
    a 20 s recording's forward calls over themselves and return the masks
    of ``mesh=None``, and calibrate with half a calibration set each to
    the threshold of one process on all of it. With the card's name and
    power limit: ms a step for one and for two ranks, ms of the gradient
    all-reduce (NCCL, one rank; gloo, through the host), peak MiB per rank.

The flagship's phases run it as ``bench.py`` does: in bfloat16 with the
bfloat16 head (``TSSEP_HEAD_BF16=1``), in float32 with the float32 head;
each phase's line names the head.

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
import os          # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import tempfile    # noqa: E402
import time        # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tssep_tpu_torch.data.device_sim import (  # noqa: E402
    DeviceMeetingSimulator, DeviceSimDataset)
from tssep_tpu_torch.data.dummy import (  # noqa: E402
    dummy_example, staircase_vad, wiener_like_mask)
from tssep_tpu_torch.eval import driver as eval_driver  # noqa: E402
from tssep_tpu_torch.eval import run as eval_cli  # noqa: E402
from tssep_tpu_torch.eval import streaming  # noqa: E402
from tssep_tpu_torch.eval.classic_bf import ClassicBF  # noqa: E402
from tssep_tpu_torch.eval.metrics import si_sdr  # noqa: E402
from tssep_tpu_torch.eval.wpe import WPE  # noqa: E402
from tssep_tpu_torch.kernels import _build  # noqa: E402
from tssep_tpu_torch.kernels import blstm as kb  # noqa: E402
from tssep_tpu_torch.nn import rnnp  # noqa: E402
from tssep_tpu_torch.signal.intervals import ArrayInterval  # noqa: E402
from tssep_tpu_torch.signal.vad import stft_vad  # noqa: E402
from tssep_tpu_torch.tasks.model import Model  # noqa: E402
from tssep_tpu_torch.config.configurable import from_config  # noqa: E402
from tssep_tpu_torch.train import run as cli  # noqa: E402
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
#: The toy recipe at its own widths (units 40, projs 42), batch 1 and 2
#: trials, as the ``recipe cli`` phase trains it: every layer fully fused,
#: clusters of 8 CTAs with 5 active. pre_net on the 553 features at 1 row,
#: birnn0 on the 513 conditioned features and birnn1 on 42 at 16 rows (8
#: speakers x 2 trials), the stacked birnn2 on 8 x 42 = 336 at 2 rows, and
#: at 16 rows.
RECIPE_CLI_UNITS, RECIPE_CLI_PROJS = 40, 42
RECIPE_CLI_CASES = [
    ('recipe cli pre_net', 1, FRAMES, 553, RECIPE_CLI_UNITS),
    ('recipe cli birnn0', 2 * SPEAKERS, FRAMES, BINS, RECIPE_CLI_UNITS),
    ('recipe cli birnn1', 2 * SPEAKERS, FRAMES, RECIPE_CLI_PROJS,
     RECIPE_CLI_UNITS),
    ('recipe cli birnn2', 2, FRAMES, SPEAKERS * RECIPE_CLI_PROJS,
     RECIPE_CLI_UNITS),
    ('recipe cli birnn2 16 rows', 16, FRAMES, SPEAKERS * RECIPE_CLI_PROJS,
     RECIPE_CLI_UNITS)]
#: (label, B, T, F, H) of the fully fused kernel's calls and (label, B, T, H)
#: of the bidi kernel's. The 'serve' rows are one request of batch 16, the
#: others the flagship training shapes at batch 256.
#: The long-recording eval's forward call (``eval/driver.py``, 8 chunks of
#: 316 frames at the flagship's widths): pre_net and the stacked birnn2 on 8
#: rows, birnn0 and birnn1 on 8 chunks x 8 speakers = 64 rows.
EVAL_BATCH_CHUNKS = 8
EVAL_CASES = [('eval pre_net', EVAL_BATCH_CHUNKS, FRAMES, BINS, HIDDEN),
              ('eval birnn0', EVAL_BATCH_CHUNKS * SPEAKERS, FRAMES, BINS,
               HIDDEN),
              ('eval birnn1', EVAL_BATCH_CHUNKS * SPEAKERS, FRAMES, 320,
               HIDDEN)]
FULLFUSED_CASES = [('ragged', 13, 23, 12, 16),
                   ('serve pre_net', 16, FRAMES, BINS, HIDDEN),
                   ('serve birnn0', 16 * SPEAKERS, FRAMES, BINS, HIDDEN),
                   ('serve birnn1', 16 * SPEAKERS, FRAMES, 320, HIDDEN),
                   ('pre_net', 256, FRAMES, BINS, HIDDEN),
                   ('birnn0', 256 * SPEAKERS, FRAMES, BINS, HIDDEN),
                   ('birnn1', 256 * SPEAKERS, FRAMES, 320, HIDDEN),
                   *RECIPE_CASES, *RECIPE_CLI_CASES, *EVAL_CASES]
#: 'fullfuse=False' rows are the folded layers' calls on that path.
BIDI_CASES = [('ragged', 13, 23, 16),
              ('serve birnn2', 16, FRAMES, HIDDEN),
              ('birnn2', 256, FRAMES, HIDDEN),
              ('fullfuse=False birnn0', 16 * SPEAKERS, FRAMES, HIDDEN),
              ('eval birnn2', EVAL_BATCH_CHUNKS, FRAMES, HIDDEN)]
#: The backward kernels' calls: 'train' rows are one training step at
#: batch 16, the others the bench's batch 256.
FULLFUSED_BWD_CASES = [('ragged', 13, 23, 12, 16),
                       ('train pre_net', 16, FRAMES, BINS, HIDDEN),
                       ('train birnn0', 16 * SPEAKERS, FRAMES, BINS, HIDDEN),
                       ('train birnn1', 16 * SPEAKERS, FRAMES, 320, HIDDEN),
                       ('pre_net', 256, FRAMES, BINS, HIDDEN),
                       ('birnn0', 256 * SPEAKERS, FRAMES, BINS, HIDDEN),
                       ('birnn1', 256 * SPEAKERS, FRAMES, 320, HIDDEN),
                       *RECIPE_CASES, *RECIPE_CLI_CASES]
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
#: ``lstm_fwd``'s calls in ``serve streaming`` (the flagship, H 300): a block
#: launches, for each of its four layers, the chunk forward (T 50) from the
#: carried state, the lookahead forward (T 12) from the state committed at
#: the chunk's end and the reverse over the block (T 62); pre_net and the
#: stacked birnn2 on 1 row, birnn0 and birnn1 on the 8 speakers' rows. Each
#: case starts from a nonzero state (``lstm_case``), the reverse too, where
#: the session starts it from zeros (the same work).
STREAM_CHUNK, STREAM_LOOKAHEAD = 50, 12
STREAM_CASES = [(f'stream {part}', B, T, HIDDEN, rev) for B in (1, SPEAKERS)
                for part, T, rev in (
                    ('chunk', STREAM_CHUNK, False),
                    ('lookahead', STREAM_LOOKAHEAD, False),
                    ('reverse', STREAM_CHUNK + STREAM_LOOKAHEAD, True))]



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


def _card():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def phase_device():
    log(f'card: {_card()}')
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
    """A call of ``lstm_fwd``; a 'stream' case starts the walk from a
    nonzero carried state (h0 in [-1, 1], c0 in [-2, 2]), as the streaming
    session's chunk and lookahead launches do."""
    size = torch.finfo(dtype).bits // 8
    xg = torch.randn(B, T, 4 * H, generator=gen, device='cuda').to(dtype)
    w_hh_t = _uniform(gen, (H, 4 * H), 1 / H ** 0.5, dtype)
    state = {}
    if label.startswith('stream'):
        state = {'h0': _uniform(gen, (B, H), 1.0, dtype),
                 'c0': _uniform(gen, (B, H), 2.0, dtype)}
    got = kb.lstm_fwd(xg, w_hh_t, reverse=reverse, with_cell=True, **state)
    want = kb.lstm_fwd_plain(xg, w_hh_t, reverse=reverse, with_cell=True,
                             **state)
    name = (f'lstm_fwd {label} B={B} T={T} H={H} '
            f'{"reverse" if reverse else "forward"}'
            f'{" from a state" if state else ""}')
    library = _selection_lstm(name, xg, w_hh_t[None], want[0], dtype,
                              reverse=reverse, **state)
    row = _case(
        name, dtype, lambda: kb.lstm_fwd(xg, w_hh_t, reverse=reverse,
                                         **state),
        lambda: kb.lstm_fwd_plain(xg, w_hh_t, reverse=reverse, **state),
        got, want, flops=2 * B * T * H * 4 * H,
        nbytes=size * (B * T * 4 * H + H * 4 * H + B * T * H
                       + (2 * B * H if state else 0)),
        library=library.forward, library_label=SELECTION_LIBRARY,
        tol=CLUSTER_TOL['lstm_fwd'] if dtype == BF16 else None)
    row['design'] = DESIGNS['lstm_fwd'][row['dtype']]
    if state:
        row['from_state'] = True
    if dtype == BF16:
        first_state = tuple(state.values()) or None
        row['first_design_ms'] = cuda_ms(
            lambda: kb._lstm_fwd_first(xg, w_hh_t, reverse, False,
                                       first_state))
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
    call (``forward``, from the kernel's carried state where it has one) and
    its backward from a kept graph (``backward``, made on first use), on
    the inputs the kernel takes."""

    def __init__(self, lstm, xg_in, h_out, state=None):
        self.lstm, self.xg_in, self.h_out = lstm, xg_in, h_out
        self.state = state

    def forward(self):
        return self.lstm(self.xg_in, self.state)

    def backward(self, dh):
        xg_leaf = self.xg_in.detach().requires_grad_()
        out, _ = self.lstm(xg_leaf)
        weights = [p for n, p in self.lstm.named_parameters()
                   if n.startswith('weight_hh')]
        return lambda: torch.autograd.grad(out, [xg_leaf, *weights],
                                           self.h_out(dh), retain_graph=True)


def _selection_lstm(name, xg, w_hh_t, h_ref, dtype, reverse=False,
                    ref='the plain version', h0=None, c0=None):
    """cuDNN's ``torch.nn.LSTM`` with input width G = 4H n (n directions),
    ``weight_ih`` of direction d the selection [0 .. I_4H .. 0] of xg's
    columns [4H d, 4H (d + 1)), zero biases and ``weight_hh`` = w_hh_t[d]^T:
    h = the gate-input kernel's h on xg (one direction from ``h0``, ``c0``
    where given). One direction with ``reverse`` runs on the time-flipped
    xg (flipped once, outside the timed call). Checks its h against
    ``h_ref``, the plain version's (or, where ``ref`` says so, the
    kernel's); returns the :class:`_Selection`."""
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
    state = None if h0 is None else (h0[None].contiguous(),
                                     c0[None].contiguous())
    with torch.no_grad():
        h = flip(lstm(xg_in, state)[0])
    err = (h.float() - h_ref.float()).abs().max().item()
    log(f'{name}: {SELECTION_LIBRARY}: h max abs err against {ref} '
        f'{err:.3g} (tolerance {SELECTION_ATOL[dtype]})')
    check(err <= SELECTION_ATOL[dtype], f'{name}: the selection LSTM computes '
          f'the kernel\'s function ({err:.3g})')
    return _Selection(lstm, xg_in, flip, state)


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
            ('lstm_fwd', lstm_case, LSTM_CASES + STREAM_CASES),
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
    log(f'serve {dtype}, {_head(model)}: kernels against {what}: mask max '
        f'abs err {mask_err:.3g}, waveform max abs err / peak '
        f'{wave_err:.3g} (tolerance {SERVE_ATOL[dtype]})')
    check(mask_err <= SERVE_ATOL[dtype], f'{dtype} served masks ({what})')
    check(wave_err <= SERVE_ATOL[dtype], f'{dtype} served waveforms ({what})')
    return {'mask_err': mask_err, 'wave_err': wave_err}


def _flagship(storage_dtype=BF16, trials=1, **switches):
    """The flagship model with random weights from seed 0; in bfloat16
    storage with the bfloat16 head, as ``bench.py:42,49`` runs it
    (``TSSEP_COMPUTE_DTYPE=bfloat16``, ``TSSEP_HEAD_BF16=1``), in float32
    with the float32 head."""
    return _model(dict(FLAGSHIP, mask_estimator=dict(
        FLAGSHIP['mask_estimator'], num_averaged_permutations=trials)),
        storage_dtype, head_dtype=storage_dtype, **switches)


def _model(cfg, storage_dtype=BF16, **switches):
    """The model of ``cfg`` with random weights from seed 0."""
    model = Model.from_config(cfg, storage_dtype=storage_dtype,
                              device='cuda', **switches)
    return model.init_params(torch.Generator().manual_seed(0))


def _head(model):
    """The head's type, for the phase lines: 'head bfloat16' or 'head
    float32'."""
    return 'head ' + str(model.mask_estimator.head_dtype).split('.')[-1]


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
    log(f'serve: {REQUESTS} requests of batch {SERVE_BATCH}, {_head(model)}, '
        f'ms each {[round(t, 2) for t in times]}, launches {launches}')
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


def _profiled_step(label, trainer, batch):
    """Device time of one training step by kernel group and the device's
    idle share, from ``torch.profiler``, logged; None where the profiler
    fails or records no device time. A failure of the step itself is
    raised."""
    from torch.profiler import ProfilerActivity, profile
    failed_step = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            try:
                trainer.train_step(batch)
                torch.cuda.synchronize()
            except Exception as exc:
                failed_step = exc
                raise
    except (RuntimeError, AttributeError) as exc:
        if failed_step is not None:
            raise
        log(f'{label}: profiler failed: {exc}')
        log(f'{label}: step split from torch.profiler (ms): not measured')
        return None
    wall_ms = 1e3 * (time.perf_counter() - t0)
    split = dict.fromkeys(list(_STEP_KERNELS) + ['other device work'], 0.0)
    for key, ms in _device_events(prof):
        group = next((g for g, names in _STEP_KERNELS.items()
                      if any(n in key for n in names)),
                     'other device work')
        split[group] += ms
    busy = sum(split.values())
    if busy == 0:
        split = None
    else:
        split['device idle'] = wall_ms - busy
        split['wall (profiled)'] = wall_ms
        split['idle share'] = split['device idle'] / wall_ms
    log(f'{label}: step split from torch.profiler (ms): '
        f'{json.dumps(split) if split else "not measured"}')
    return split


def _train(model, steps, per_step, label):
    """``Trainer.train_steps`` for ``steps`` steps of batch ``TRAIN_BATCH``
    on the simulator's batches, with the launch counts set to 0 just before; checks
    the losses and that each step launched ``per_step``."""
    sim = DeviceMeetingSimulator(duration=SAMPLES / 16000,
                                 num_speakers=SPEAKERS, aux_size=BINS)
    data = DeviceSimDataset(sim, TRAIN_BATCH, seed=2,
                            targets=model.loss.device_targets() | {'Vad'},
                            device='cuda')
    trainer = Trainer(model, None, optimizer=Adam(gradient_clipping=10,
                                                  lr=1e-3), seed=0)

    _reset_launches()
    t0 = time.perf_counter()
    losses = trainer.train_steps(data, steps)
    train_s = time.perf_counter() - t0
    launches = _launches()
    log(f'{label}: Trainer.train_steps {steps} steps of batch {TRAIN_BATCH}, '
        f'{_head(model)}, in {train_s:.2f} s (first calls included), losses '
        f'{losses}, launches {launches}')
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
    split = _profiled_step('train', trainer, batch)

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
    log(f'{label}: {REQUESTS} requests of batch {SERVE_BATCH}, '
        f'{_head(model)}, ms each {[round(t, 2) for t in times]}, launches '
        f'{launches}')
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
    split = _profiled_step(label, trainer, batch)
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
        f'{channels} channel(s), {_head(model)}, ms each '
        f'{[round(t, 2) for t in times]}, launches {launches}')
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
    split = _profiled_step(label, trainer, batch)
    agree = _train_checks(model, batch, label, cfg=cfg)
    peak = _peak_mib(lambda: _step_grads(model, batch, False))
    log(f'{label}: peak memory of one step\'s forward and backward at batch '
        f'{TRAIN_BATCH} over the weights (MiB): {peak:.2f}')
    return {'launches': launches, 'losses': losses, 'step_ms': step_ms,
            'gen_ms': gen_ms, 'split_profiler': split, 'peak_mib': peak,
            'agreement': agree}


#: The toy recipe through the port's CLI (``tssep_tpu_torch/exp``'s YAMLs,
#: the triggers overridden on the command line): TS-VAD at the YAML's
#: widths in the CLI's default float32, TS-SEP warm-started from its best
#: checkpoint and cold-started; then TS-VAD at the flagship's widths in
#: bfloat16. Iterations (stop), checkpoint and summary triggers per run.
RECIPE_EXP = Path('tssep_tpu_torch') / 'exp'
RECIPE_VAD = (400, 200, 100)
RECIPE_SEP = (20, 20, 10)
RECIPE_FLAGSHIP = (12, 12, 4)
#: Kernels on the toy's path (every layer fully fused) and, at the
#: flagship's widths, the stacked birnn2 (8 x 320 = 2560 wide) on the bidi
#: pair.
RECIPE_CLI_KERNELS = ('blstm_fullfused_fwd', 'blstm_fullfused_bwd')
RECIPE_FLAGSHIP_KERNELS = RECIPE_CLI_KERNELS + ('blstm_bidi_fwd',
                                                'blstm_bidi_bwd')


def _stage_args(stage, storage, triggers, *extra):
    stop, ckpt, summary = triggers
    return ['with', str(RECIPE_EXP / 'init_cfg_common.yaml'),
            str(RECIPE_EXP / f'init_cfg_{stage}.yaml'),
            f'eg.trainer.storage_dir={storage}',
            f'eg.trainer.stop_trigger=[{stop},iteration]',
            f'eg.trainer.checkpoint_trigger=[{ckpt},iteration]',
            f'eg.trainer.summary_trigger=[{summary},iteration]', *extra]


def _timed(name, times):
    """``Trainer.<name>`` timed (CUDA-synchronized) into ``times``."""
    original = getattr(Trainer, name)

    def wrapper(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(self, *args, **kwargs)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        return out
    return mock.patch.object(Trainer, name, wrapper)


def _metrics(storage):
    return [json.loads(line) for line in
            (Path(storage) / 'metrics.jsonl').read_text().splitlines()]


def _ms_per_iteration(storage, triggers):
    """ms per iteration between consecutive train summaries, over the
    intervals that hold no validation or checkpoint (the snapshot forward
    of a summary is in them)."""
    _, ckpt, _ = triggers
    flushes = [(r['step'], r['time']) for r in _metrics(storage)
               if 'train/loss' in r]
    return [1e3 * (t1 - t0) / (s1 - s0)
            for (s0, t0), (s1, t1) in zip(flushes, flushes[1:])
            if s0 % ckpt]


def _cli_run(label, args, kernels, triggers):
    """``tssep_tpu_torch.train.run.main(args)`` in this process on the
    card, with the launch counts set to 0 just before and read just after;
    checks the storage dir and that only ``kernels`` were launched, each
    at least once."""
    storage = Path(next(a for a in args if a.startswith(
        'eg.trainer.storage_dir=')).partition('=')[2])
    saves, validations = [], []
    _reset_launches()
    t0 = time.perf_counter()
    with _timed('save', saves), _timed('validate', validations):
        eg = cli.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    stop = triggers[0]
    check(eg.trainer.iteration == stop, f'{label}: {stop} iterations')
    for name in ('config.yaml', 'Makefile', 'python_history.txt',
                 'metrics.jsonl', 'checkpoints/ckpt_latest.npz',
                 'checkpoints/ckpt_best_loss.npz'):
        check((storage / name).exists(), f'{label}: {name} written')
    check('tssep_tpu_torch.train.run' in (storage / 'Makefile').read_text(),
          f'{label}: the Makefile names the port\'s CLI')
    check(all(launches[k] > 0 for k in kernels)
          and not any(v for k, v in launches.items() if k not in kernels),
          f'{label}: launches only and each of {kernels}, got {launches}')
    metrics = _metrics(storage)
    losses = [r['train/loss'] for r in metrics if 'train/loss' in r]
    val = [r['validation/mean_loss'] for r in metrics
           if 'validation/mean_loss' in r]
    check(all(map(math.isfinite, losses + val)), f'{label}: finite losses')
    failed = [r for r in metrics if 'train/snapshot_errors' in r
              or 'validation/snapshot_errors' in r]
    check(not failed, f'{label}: no snapshot forward failed, got {failed}')
    out = {'launches': launches, 'seconds': seconds,
           'ms_per_iteration': _ms_per_iteration(storage, triggers),
           'save_ms': saves, 'validate_ms': validations,
           'train_losses': losses, 'validation_losses': val}
    log(f'{label}: {json.dumps(out)}')
    return eg, out


def _si_sdr(reference, estimate):
    """Scale-invariant SDR in dB over the last axis (float64)."""
    reference = np.asarray(reference, np.float64)
    estimate = np.asarray(estimate, np.float64)
    alpha = (np.sum(reference * estimate, -1, keepdims=True)
             / np.maximum(np.sum(reference ** 2, -1, keepdims=True), 1e-12))
    target = alpha * reference
    return 10 * np.log10(np.maximum(np.sum(target ** 2, -1), 1e-12)
                         / np.maximum(np.sum((estimate - target) ** 2, -1),
                                      1e-12))


def _zero_shot(args):
    """The TS-SEP stage of ``args`` built by the CLI's own functions,
    warm-started by its ``init_ckpt`` and not trained: its validation loss
    and the SI-SDR gain of its separated waveforms over the mixture,
    averaged over the validation examples and speakers."""
    command, files, overrides = cli.parse_argv(args)
    config = cli.build_config(files, overrides)
    eg = from_config(config['eg'], **cli.runtime_options(args))
    trainer, model = eg.trainer, eg.trainer.model
    trainer.ensure_init()
    eg.init_ckpt(eg)
    data = model.prepare_validate_dataset(prefetch=False)
    trainer.register_validation_hook(data)
    loss, _ = trainer.validate()
    gains = []
    for ex in data:
        with torch.no_grad():
            est = model(ex).time_estimate.cpu().numpy()
        ref = ex['speaker_reverberation_early_ch0'].cpu().numpy()
        mix = ex['observation'][0].cpu().numpy()
        gains.append(np.mean(_si_sdr(ref, est) - _si_sdr(ref, mix[None])))
    return {'validation_loss': loss, 'si_sdr_gain_db': float(np.mean(gains))}


def _recipe_step(label, eg):
    """One recipe step of ``eg``'s trainer under ``torch.profiler``."""
    batch = next(iter(eg.trainer.model.prepare_train_dataset(
        prefetch=False, batch_size=1)))
    return _profiled_step(label, eg.trainer, batch)


#: Iterations a resumed run has done before it starts: none, the TS-VAD
#: run's, and the JAX trainer's default stop trigger.
RESUME_AT = (0, RECIPE_VAD[0], 416666)


def _resume_skip(eg):
    """ms (host) to the first batch of the stage's training data, prepared
    as the Experiment prepares it, from where a run resumed after each of
    ``RESUME_AT`` iterations starts (``Dataset.iter_from``)."""
    model, vmb = eg.trainer.model, eg.trainer.virtual_minibatch_size
    out = {}
    for done in RESUME_AT:
        data = model.prepare_train_dataset(prefetch=True,
                                           batch_size=eg.train_batchsize)
        t0 = time.perf_counter()
        it = data.tile(None).iter_from(done * vmb)
        next(it)
        torch.cuda.synchronize()
        out[done] = 1e3 * (time.perf_counter() - t0)
        it.close()
    log(f'resume: ms to the first batch after (iterations: ms) '
        f'{json.dumps(out)}')
    return out


def phase_recipe_cli(tmp):
    """The toy recipe's two stages through ``tssep_tpu_torch.train.run.main``
    on the card in the directory ``tmp`` (the ``eval cli`` phase evaluates
    its ``warm`` storage dir), float32 (the CLI's default):
    TS-VAD trained ``RECIPE_VAD[0]`` iterations with checkpoints and
    validation; TS-SEP warm-started from its ``ckpt_best_loss.npz`` and
    cold-started, each trained a few iterations; the zero-shot validation
    loss and SI-SDR gain of both, which the warm start must win."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.pop('TSSEP_COMPUTE_DTYPE', None)
    vad_args = _stage_args('tsvad', tmp / 'tsvad', RECIPE_VAD)
    eg, vad = _cli_run('recipe cli tsvad', ['train', *vad_args],
                       RECIPE_CLI_KERNELS, RECIPE_VAD)
    me = eg.trainer.model.mask_estimator
    check((me.units, me.projs, me.storage_dtype)
          == (RECIPE_CLI_UNITS, RECIPE_CLI_PROJS, F32),
          'recipe cli: the YAML\'s widths in float32')
    check(vad['train_losses'][-1] < vad['train_losses'][0],
          f'recipe cli tsvad: the loss falls, {vad["train_losses"]}')
    vad['profiled_step'] = _recipe_step('recipe cli tsvad', eg)
    vad['resume_first_batch_ms'] = _resume_skip(eg)
    best = (tmp / 'tsvad' / 'checkpoints' / 'ckpt_best_loss.npz').resolve()
    warm = _stage_args('tssep', tmp / 'warm', RECIPE_SEP,
                       f'eg.init_ckpt.init_ckpt={best}')
    cold = _stage_args(
        'tssep', tmp / 'cold', RECIPE_SEP,
        'eg.init_ckpt={factory: '
        'tssep_tpu_torch.train.init_ckpt.InitCheckPoint}')
    zero = {'warm': _zero_shot(warm), 'cold': _zero_shot(cold)}
    log(f'recipe cli: zero-shot TS-SEP: {json.dumps(zero)}')
    runs = {}
    for name, args in (('warm', warm), ('cold', cold)):
        _, runs[name] = _cli_run(f'recipe cli tssep {name}',
                                 ['train', *args], RECIPE_CLI_KERNELS,
                                 RECIPE_SEP)
    check(zero['warm']['validation_loss'] < zero['cold']['validation_loss']
          and zero['warm']['si_sdr_gain_db']
          > zero['cold']['si_sdr_gain_db'],
          f'recipe cli: the warm start beats the cold start at zero '
          f'shot, {zero}')
    return {'tsvad': vad, 'tssep warm': runs['warm'],
            'tssep cold': runs['cold'], 'zero_shot': zero}


def phase_recipe_cli_flagship():
    """TS-VAD through the CLI at the flagship's widths (units 300, projs
    320) in bfloat16 (``TSSEP_COMPUTE_DTYPE``): the stacked birnn2, 2560
    wide, adds the bidi pair."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ['TSSEP_COMPUTE_DTYPE'] = 'bfloat16'
    try:
        with tempfile.TemporaryDirectory(prefix='tssep_recipe_') as tmp:
            args = _stage_args(
                'tsvad', Path(tmp) / 'tsvad', RECIPE_FLAGSHIP,
                f'eg.trainer.model.mask_estimator.units={HIDDEN}',
                'eg.trainer.model.mask_estimator.projs=320')
            eg, out = _cli_run('recipe cli flagship', ['train', *args],
                               RECIPE_FLAGSHIP_KERNELS, RECIPE_FLAGSHIP)
            me = eg.trainer.model.mask_estimator
            check((me.units, me.projs, me.storage_dtype)
                  == (HIDDEN, 320, BF16),
                  'recipe cli flagship: widths and bfloat16')
            out['profiled_step'] = _recipe_step('recipe cli flagship', eg)
    finally:
        os.environ.pop('TSSEP_COMPUTE_DTYPE', None)
    return out


#: The long-recording eval (``tssep_tpu_torch/eval``): a recording of 60 s,
#: 7 channels and 8 speakers made from seed 0 by ``DummyReader``'s generator
#: (its staircase VAD stretched to 60 s) and its aux; chunks of 316 frames
#: (5 s) every 158, 8 a forward call.
EVAL_SECONDS, EVAL_CHANNELS = 60, 7
EVAL_CHUNK, EVAL_HOP = FRAMES, FRAMES // 2
#: Per forward call of the flagship: pre_net, birnn0 and birnn1 fully fused,
#: the stacked birnn2 on the bidi pair.
EVAL_PER_CALL = {'blstm_fullfused_fwd': 3, 'blstm_bidi_fwd': 1}
#: ClassicBF's WPE on the card (``wpe_torch``, float64) against the numpy
#: float64 WPE, on a reverberant mixture of the recording's first seconds'
#: shape: white-noise speakers under the staircase VAD, each convolved per
#: channel with a random exponentially decaying response (-60 dB over
#: 0.25 s), oracle masks and diarization. The enhanced STFT's max abs error
#: over its peak (the same float64 statistics, summed in another order).
#: DummyReader's sinusoids do not serve here: a pure tone is predicted
#: exactly, its residual power falls to the 1/power weights' floor, and
#: WPE's statistics turn singular (numpy's complex solve and a float64
#: real-block solve then differ by 0.43 of the peak).
WPE_SECONDS, WPE_TOL, WPE_RT = 10, 1e-6, 0.25
#: ``eval cli``: the toy recipe's forward per call at its own widths, every
#: layer fully fused (birnn2 8 x 42 = 336 wide).
EVAL_CLI_PER_CALL = {'blstm_fullfused_fwd': 4}


def _eval_recording():
    """(observation, aux, vad, speakers' signals) of the eval recording."""
    ex = dummy_example(0, 16_000 * EVAL_SECONDS, SPEAKERS, EVAL_CHANNELS,
                       aux_size=BINS,
                       load_keys=('speaker_reverberation_early_ch0',))
    audio = ex['audio_data']
    return (audio['observation'], ex['auxInput'], audio['vad'],
            audio['speaker_reverberation_early_ch0'])


def _eval_driver(model):
    driver = eval_driver.EvalDriver(model, chunk_frames=EVAL_CHUNK,
                                    hop_frames=EVAL_HOP)
    check(driver.chunked.batch_chunks == EVAL_BATCH_CHUNKS,
          f'eval: {driver.chunked.batch_chunks} chunks per forward call')
    return driver


def _eval_run(label, driver, recording, beamform, calls):
    """One recording through ``driver`` with the launch counts set to 0
    just before and read just after: checks the outputs and the launches
    (``EVAL_PER_CALL`` per forward call); the ms per stage, DER scoring
    included."""
    obs, aux, vad, speakers = recording
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = driver.run_recording(obs, aux, beamform=beamform)
    t1 = time.perf_counter()
    score = driver.score_der(result, vad)
    t2 = time.perf_counter()
    launches = _launches()
    masks, est = result['masks'], result['time_estimate']
    frames = driver.model.fe.num_frames(obs.shape[-1])
    check(masks.shape == (SPEAKERS, 1, frames, BINS)
          and masks.dtype == np.float32, f'{label}: masks {masks.shape}')
    check(est.shape == (SPEAKERS, obs.shape[-1]),
          f'{label}: waveforms {est.shape}')
    check(bool(np.isfinite(masks).all() and np.isfinite(est).all()
               and np.isfinite(result['activity']).all()),
          f'{label}: finite outputs')
    check(result['num_segments'] > 0 and result['beamformed'] == beamform,
          f'{label}: {result["num_segments"]} segments')
    check(launches == _expect(EVAL_PER_CALL, calls),
          f'{label}: {EVAL_PER_CALL} per forward call, {calls} calls, got '
          f'{launches}')
    stage_ms = dict(result['stage_ms'], der=1e3 * (t2 - t1))
    vals = si_sdr(speakers, est)
    out = {'launches': launches, 'stage_ms': stage_ms,
           'ms': 1e3 * (t2 - t0), 'run_ms': 1e3 * (t1 - t0),
           'seconds_per_audio_second': (t2 - t0) / EVAL_SECONDS,
           'num_segments': result['num_segments'],
           'frames_covered': _frames_covered(result['dia']),
           'der': score['der'],
           'si_sdr_db': float(np.mean(vals[np.isfinite(vals)]))}
    log(f'{label}: {json.dumps(out)}')
    return result, out


def _frames_covered(dia):
    """(speaker, frame) pairs inside a diarized segment."""
    return int(sum(np.asarray(ai, dtype=bool).sum() for ai in dia))


def _reference_enhancer(driver, recording, result):
    """The enhancer timed on the recording's reference diarization (its
    own VAD through ``stft_vad``: every speaker's runs) with ``result``'s
    masks, so that its time is that of the segments an evaluated meeting
    has rather than of the random model's diarization. Returns the ms, the
    segments and the frames covered, and the seconds per second of audio
    of the run with this enhancer time in place of its own."""
    obs, _, vad, speakers = recording
    fe = driver.model.fe
    dia = [ArrayInterval(a) for a in stft_vad(vad, fe.window_length,
                                              fe.shift, fe.fading)]
    obs_host = eval_driver.to_numpy(driver.stft(obs)).astype(np.complex128)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = driver.enhancer(result['masks'], obs_host, dia)
    ms = 1e3 * (time.perf_counter() - t0)
    check(bool(np.isfinite(est).all()), 'eval reference enhancer: finite')
    segments = sum(len(ai.normalized_intervals) for ai in dia)
    check(segments > 0, 'eval reference enhancer: segments')
    return {'enhancer_ms': ms, 'num_segments': segments,
            'frames_covered': _frames_covered(dia)}


def _eval_agreement(label, driver, recording, result, dtype):
    """The same driver's masks and activity through the plain versions,
    at ``SERVE_ATOL``; the diarized frames that differ."""
    obs, aux, *_ = recording
    with _plain_versions():
        masks, activity = driver.chunked(driver.stft(obs), aux)
    mask_err = float(np.abs(result['masks'] - masks).max())
    act_err = float(np.abs(result['activity'] - activity).max())
    dia = eval_driver.diarize_from_activity(
        activity, driver.vad_threshold, driver.smooth_kernel,
        driver.min_frames, driver.merge_gap_frames, driver.pad_frames)
    flipped = int(sum((np.asarray(a) != np.asarray(b)).sum()
                      for a, b in zip(dia, result['dia'])))
    log(f'{label} {dtype}: kernels against plain versions: masks max abs '
        f'err {mask_err:.3g}, activity {act_err:.3g} (tolerance '
        f'{SERVE_ATOL[dtype]}); diarized frames that differ: {flipped} of '
        f'{activity.size}')
    check(mask_err <= SERVE_ATOL[dtype] and act_err <= SERVE_ATOL[dtype],
          f'{label} {dtype}: masks and activity against the plain versions')
    return {'mask_err': mask_err, 'activity_err': act_err,
            'dia_frames_differ': flipped}


def _reverberant_mixture(seconds, seed=0):
    """(observation (mic, samples), speaker images at channel 0, sample
    VAD) of white-noise speakers convolved with random decaying
    responses."""
    import scipy.signal
    rng = np.random.default_rng(seed)
    n = 16_000 * seconds
    vad = staircase_vad(n, SPEAKERS)
    taps = int(WPE_RT * 16_000)
    rirs = (rng.standard_normal((SPEAKERS, EVAL_CHANNELS, taps))
            * np.exp(-6.9 * np.arange(taps) / taps))
    images = scipy.signal.fftconvolve(
        (rng.standard_normal((SPEAKERS, n)) * vad)[:, None], rirs,
        axes=-1)[..., :n]
    obs = images.sum(0) + 1e-3 * rng.standard_normal((EVAL_CHANNELS, n))
    return obs.astype(np.float32), images[:, 0].astype(np.float32), vad


def _wpe_against_numpy(model):
    """``ClassicBF(pre_wpe=WPE(backend='torch'))`` against the numpy WPE on
    a reverberant mixture, the oracle masks and diarization; both timed."""
    obs, images, vad = _reverberant_mixture(WPE_SECONDS)
    fe = model.fe

    def stft(x):
        return eval_driver.to_numpy(fe.stft(torch.as_tensor(
            x, device='cuda'))).astype(np.complex128)

    observation, image_stft = stft(obs), stft(images)
    masks = wiener_like_mask(np.abs(image_stft)[:, None])
    dia = [ArrayInterval(a) for a in stft_vad(vad, fe.window_length,
                                              fe.shift, fe.fading)]
    out, ms = {}, {}
    for backend in ('torch', 'numpy'):
        enhancer = ClassicBF(pre_wpe=WPE(backend=backend, device='cuda'))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[backend] = enhancer(masks, observation, dia)
        torch.cuda.synchronize()
        ms[backend] = 1e3 * (time.perf_counter() - t0)
    peak = float(np.abs(out['numpy']).max())
    err = float(np.abs(out['torch'] - out['numpy']).max()) / peak
    log(f'eval flagship: ClassicBF with WPE on a reverberant mixture, '
        f'{WPE_SECONDS} s, {EVAL_CHANNELS} channels (taps 10, delay 2, 3 '
        f'iterations): torch float64 on the card {ms["torch"]:.1f} ms, numpy '
        f'{ms["numpy"]:.1f} ms; enhanced STFT max abs err / peak {err:.3g} '
        f'(tolerance {WPE_TOL})')
    check(err <= WPE_TOL, 'WPE torch against numpy')
    return {'ms': ms, 'err': err}


def phase_eval_flagship():
    """The flagship (bf16, random weights from seed 0) evaluates the 60 s
    recording through ``EvalDriver``: with ``ClassicBF`` (MVDR) and with
    masking, ceil(chunks / 8) forward calls each; masks and activity
    against the plain versions in bf16 and in f32 storage; the ms per
    stage; the MVDR on the reference diarization; the peak memory;
    ClassicBF's WPE on the card against numpy on a
    reverberant mixture."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recording = _eval_recording()
    model = _flagship()
    driver = _eval_driver(model)
    frames = model.fe.num_frames(recording[0].shape[-1])
    chunks = len(eval_driver._chunk_starts(frames, EVAL_CHUNK, EVAL_HOP))
    calls = -(-chunks // EVAL_BATCH_CHUNKS)
    log(f'eval flagship: {EVAL_SECONDS} s, {EVAL_CHANNELS} channels, '
        f'{frames} frames, {chunks} chunks of {EVAL_CHUNK} every {EVAL_HOP}, '
        f'{calls} forward calls of {EVAL_BATCH_CHUNKS}, {_head(model)}')
    driver.run_recording(*recording[:2], beamform=False)      # warm-up
    runs = {}
    for name, beamform in (('beamform', True), ('masking', False)):
        result, runs[name] = _eval_run(f'eval flagship {name}', driver,
                                       recording, beamform, calls)
        if beamform:
            ref = _reference_enhancer(driver, recording, result)
            run = runs[name]
            ref['seconds_per_audio_second'] = (
                run['ms'] - run['stage_ms']['enhancer']
                + ref['enhancer_ms']) / 1e3 / EVAL_SECONDS
            run['reference_dia'] = ref
            log(f'eval flagship beamform: enhancer '
                f'{run["stage_ms"]["enhancer"]:.1f} ms on the model\'s '
                f'{run["num_segments"]} segments ({run["frames_covered"]} '
                f'speaker-frames), {ref["enhancer_ms"]:.1f} ms on the '
                f'reference diarization\'s {ref["num_segments"]} segments '
                f'({ref["frames_covered"]} speaker-frames); with the '
                f'latter {ref["seconds_per_audio_second"]:.4f} s per second '
                f'of audio')
    agree = {'bf16': _eval_agreement('eval flagship', driver, recording,
                                     result, BF16)}
    driver32 = _eval_driver(_flagship(F32))
    result32 = driver32.run_recording(*recording[:2], beamform=False)
    agree['f32'] = _eval_agreement('eval flagship', driver32, recording,
                                   result32, F32)
    peak = _peak_mib(lambda: driver.run_recording(*recording[:2],
                                                  beamform=False))
    log(f'eval flagship: peak memory of one recording over the weights '
        f'(MiB): {peak:.2f}')
    wpe = _wpe_against_numpy(model)
    return {'chunks': chunks, 'calls': calls, **runs, 'agreement': agree,
            'peak_mib': peak, 'wpe': wpe}


def _eval_cli_run(label, storage, *overrides):
    """``tssep_tpu_torch.eval.run.main`` on ``storage``'s config.yaml in
    this process on the card, the launch counts set to 0 just before and
    read just after; checks metrics.json."""
    out_dir = storage / f'eval_{label.split()[-1]}'
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = eval_cli.main(['with', str(storage / 'config.yaml'),
                             f'out={out_dir}', *overrides])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    check(json.loads((out_dir / 'metrics.json').read_text()) == metrics,
          f'{label}: metrics.json written')
    summary, records = metrics['summary'], metrics['per_recording']
    calibration = metrics['calibration']
    check(calibration is not None and 'error' not in calibration,
          f'{label}: calibration without error, got {calibration}')
    check(math.isfinite(summary.get('mean_der', math.nan))
          and math.isfinite(summary.get('mean_si_sdr', math.nan)),
          f'{label}: finite mean DER and SI-SDR, got {summary}')
    check(records and all(r['num_segments'] > 0 for r in records),
          f'{label}: segments on every recording')
    check(metrics['wav_writer'] == 'native',
          f'{label}: the native WAV writer, got {metrics["wav_writer"]}')
    wavs = sorted((out_dir / 'audio').glob('*.wav'))
    check(len(wavs) == SPEAKERS * len(records), f'{label}: {len(wavs)} WAVs')
    # a forward call for each calibration example and each recording, all
    # shorter than a chunk
    calls = min(4, len(records)) + len(records)
    check(launches == _expect(EVAL_CLI_PER_CALL, calls),
          f'{label}: {EVAL_CLI_PER_CALL} per forward call, {calls} calls, '
          f'got {launches}')
    ms = [sum(r['stage_ms'].values()) for r in records]
    out = {'summary': summary, 'degenerate': summary.get('degenerate', False),
           'calibration': calibration, 'launches': launches,
           'ms_per_recording': ms, 'seconds': seconds,
           'wav_writer': metrics['wav_writer']}
    log(f'{label}: {json.dumps(out)}')
    return out


def phase_eval_cli(storage):
    """The port's eval CLI on the warm-started toy TS-SEP of ``recipe
    cli`` (its YAML's widths in float32, the CLI's default): masking on
    the reader's 1 channel, then the MVDR on 7."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.pop('TSSEP_COMPUTE_DTYPE', None)
    return {'masking': _eval_cli_run('eval cli masking', storage,
                                     'beamform=false'),
            'beamform': _eval_cli_run(
                'eval cli beamform', storage,
                'eg.trainer.model.reader.num_channels=7', 'beamform=true')}


#: ``recipe simulated``: ``tssep_tpu_torch.exp.run_simulated
#: .main_multichannel`` at the R5W widths (units/projs 64, Log1pMaxNorm F
#: 513, 'gate' aux 513, 6 channels, reverb taps 2, a pool of 16 voices,
#: batch 8, 2 trials, ``explicit_vad``, ``vad_weight`` 0.3; the stages in
#: bf16, the CTC recognizer in f32) with a vocabulary of 8 words, its depth
#: cut: these meetings, iterations and CTC steps (R5W: 512 meetings, 8 eval
#: recordings, 1600 / 800 iterations, 900 steps).
RECIPE_SIM = dict(vocabulary=8, strict_comparison=False, train_examples=32,
                  eval_examples=2, tsvad_iters=40, tssep_iters=20,
                  ctc_steps=60)
RECIPE_SIM_KERNELS = ('blstm_fullfused_fwd', 'blstm_fullfused_bwd')
#: The recipe's evaluations, in the order ``main`` runs them.
RECIPE_SIM_EVALS = ('tsvad', 'tssep', 'joint masking', 'joint mvdr',
                    'joint mvdr postmask')
#: The CTC recognizer's layer (F 40 x 3 stacked, H 48) in f32 at a
#: training batch (16 rows, T 61: 1.8 s at shift 160, frames stacked by 3)
#: and at one transcribed stream (1 row), checked beside the shapes the
#: phase records.
CTC_CASES = [('recipe sim ctc step', RECIPE_SIM_KERNELS, 16, 61, 120, 48),
             ('recipe sim ctc transcribe', RECIPE_SIM_KERNELS[:1], 1, 61,
              120, 48)]


class _Shapes:
    """Records the (rows, T, F, H, dtype) of each fully fused launch that
    ``nn/rnnp.py`` makes, by stage, passing every call on to the wrapper
    (which counts it)."""

    def __init__(self):
        self.stage = None
        self.seen = {}

    def wrap(self, name):
        fn = getattr(kb, name)

        def record(x, w_ih_t, w_hh_t, *args, **kwargs):
            key = (name, x.shape[0], x.shape[1], x.shape[2],
                   w_hh_t.shape[1], x.dtype)
            self.seen.setdefault(key, self.stage)
            return fn(x, w_ih_t, w_hh_t, *args, **kwargs)
        return mock.patch.object(rnnp, name, record)


def _stage_counts(stages, label, fn, shapes):
    """``fn`` wrapped: the launch counts set to 0 just before each call and
    read just after, with its seconds, into ``stages[label]`` (a list, one
    entry a call)."""
    def run(*args, **kwargs):
        shapes.stage = label
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        stages.setdefault(label, []).append(
            {'start': t0, 'seconds': time.perf_counter() - t0,
             'launches': _launches()})
        return out
    return run


def phase_recipe_simulated(rows):
    """The simulated-corpus recipe through its launcher's function on the
    card (``RECIPE_SIM``); then the fully fused pair against its plain
    versions at each (rows, F, H) the phase launched, at the longest T, and
    at ``CTC_CASES``, into ``rows``."""
    from tssep_tpu_torch.data.shard_corpus import ShardCorpusReader
    from tssep_tpu_torch.eval import ctc
    from tssep_tpu_torch.exp import run_simulated
    from tssep_tpu_torch.runtime.native import ShardReader, ShardWriter
    from tssep_tpu_torch.train.experiment import Experiment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.pop('TSSEP_COMPUTE_DTYPE', None)
    stages, shapes, written, step_times, egs = {}, _Shapes(), [], [], {}
    asr = []
    ctc_steps, transcribe_s = [], []
    loss_fn, transcribe = ctc.CTCRecognizer.loss_fn, ctc.CTCRecognizer.__call__
    add_example = ShardWriter.add_example
    evaluate_fn = eval_cli.evaluate

    def timed_loss(self, *args):
        torch.cuda.synchronize()
        out = loss_fn(self, *args)
        ctc_steps.append((time.perf_counter(), out.detach()))
        return out

    def timed_transcribe(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = transcribe(self, *args, **kwargs)
        transcribe_s.append(time.perf_counter() - t0)
        return out

    def counted_add(self, example_id, arrays):
        written.append(Path(self.path).name)
        return add_example(self, example_id, arrays)

    train_fn, train_step = Experiment.train, Trainer.train_step
    train_on_fn = ctc.CTCRecognizer.train_on.__func__

    def train_on(cls, *args, **kwargs):
        asr.append(_stage_counts(stages, 'ctc', train_on_fn, shapes)(
            cls, *args, **kwargs))
        return asr[-1]

    def train(eg):
        label = Path(eg.trainer.storage_dir).name         # tsvad, tssep
        egs[label] = eg
        return _stage_counts(stages, label, train_fn, shapes)(eg)

    def timed_step(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(self, *args, **kwargs)
        torch.cuda.synchronize()
        step_times.append((t, 1e3 * (time.perf_counter() - t)))
        return out

    evals = iter(RECIPE_SIM_EVALS)

    def evaluate(*args, **kwargs):
        label = f'eval {next(evals)}'
        before = len(transcribe_s)
        out = _stage_counts(stages, label, evaluate_fn, shapes)(
            *args, **kwargs)
        stages[label][-1]['metrics'] = out
        stages[label][-1]['transcribe_s'] = sum(transcribe_s[before:])
        return out

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix='tssep_recipe_sim_') as tmp, \
            shapes.wrap('blstm_fullfused_fwd'), \
            shapes.wrap('blstm_fullfused_bwd'), \
            mock.patch.object(ctc.CTCRecognizer, 'loss_fn', timed_loss), \
            mock.patch.object(ctc.CTCRecognizer, '__call__',
                              timed_transcribe), \
            mock.patch.object(ShardWriter, 'add_example', counted_add), \
            mock.patch.object(ctc.CTCRecognizer, 'train_on',
                              classmethod(train_on)), \
            mock.patch.object(Experiment, 'train', train), \
            mock.patch.object(eval_cli, 'evaluate', evaluate), \
            mock.patch.object(Trainer, 'train_step', timed_step):
        work = Path(tmp) / 'mc'
        t0 = time.perf_counter()
        run_simulated.main_multichannel(work, **RECIPE_SIM)
        seconds = time.perf_counter() - t0
        counts = {split: len(ShardReader(work / f'{split}.shard').keys())
                  for split in ('train', 'validate', 'eval')}
        metrics = {stage: _metrics(work / stage) for stage in ('tsvad',
                                                               'tssep')}
        # the trained recognizer on its own: each eval recording's early
        # images (the reference streams), one call a stream
        shapes.stage = 'ctc transcribe'
        reader = ShardCorpusReader(eval_shard=str(work / 'eval.shard'))
        streams = [sig for ex in reader('eval', load_keys=(
            'speaker_reverberation_early_ch0',))
            for sig in ex['audio_data']['speaker_reverberation_early_ch0']]
        _reset_launches()
        before = len(transcribe_s)
        hypotheses = [asr[0](sig) for sig in streams]
        oracle = {'streams': len(streams),
                  'ms_per_stream': [1e3 * t for t in transcribe_s[before:]],
                  'words': sum(len(h.split()) for h in hypotheses),
                  'launches': _launches()}
        check(oracle['launches'] == _expect({'blstm_fullfused_fwd': 1},
                                            len(streams)),
              f'recipe simulated: a forward a stream, {oracle}')
        shapes.stage, profiled = 'profiled step', {}
        for name, eg in egs.items():
            batch = next(iter(eg.trainer.model.prepare_train_dataset(
                prefetch=False, batch_size=eg.train_batchsize)))
            profiled[name] = _profiled_step(f'recipe simulated {name}',
                                            eg.trainer, batch)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20

    # the corpora: the native writer's examples, read back by the reader
    want = {'train': RECIPE_SIM['train_examples'],
            'validate': max(RECIPE_SIM['eval_examples'], 2),
            'eval': RECIPE_SIM['eval_examples']}
    fields = 5                    # observation, early images, vad, aux, words
    check({split: written.count(f'{split}.shard') for split in want}
          == want and all(n == fields * want[s] for s, n in counts.items()),
          f'recipe simulated: shards {counts} entries, written {written}')
    # the CTC recognizer
    losses = [float(loss) for _, loss in ctc_steps]
    check(len(losses) == RECIPE_SIM['ctc_steps']
          and all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f'recipe simulated: CTC losses finite and falling, {losses}')
    step_ms = [1e3 * (b - a) for (a, _), (b, _) in zip(ctc_steps,
                                                       ctc_steps[1:])]
    # the stages, in order: TS-VAD, then TS-SEP
    stage_names = {'ctc': stages['ctc'][0]}
    for name in ('tsvad', 'tssep'):
        (entry,) = stages[name]
        stage_names[name] = entry
        m = metrics[name]
        vals = ([r['train/loss'] for r in m if 'train/loss' in r]
                + [r['validation/mean_loss'] for r in m
                   if 'validation/mean_loss' in r])
        check(vals and all(map(math.isfinite, vals)),
              f'recipe simulated {name}: finite losses {vals}')
        entry['losses'] = vals
    for name, entry in stage_names.items():
        launches = entry['launches']
        check(all(launches[k] > 0 for k in RECIPE_SIM_KERNELS)
              and not any(v for k, v in launches.items()
                          if k not in RECIPE_SIM_KERNELS),
              f'recipe simulated {name}: launches {launches}')
    # each stage's training steps: the last of its timed steps (its
    # pre-flight test run comes first); an iteration accumulates the
    # trainer's virtual minibatch of steps (12, the Experiment's default)
    iters = {'tsvad': RECIPE_SIM['tsvad_iters'],
             'tssep': RECIPE_SIM['tssep_iters']}
    stage_steps = {}
    for name in iters:
        entry = stage_names[name]
        vmb = egs[name].trainer.virtual_minibatch_size
        inside = [ms for t, ms in step_times
                  if entry['start'] <= t <= entry['start'] + entry['seconds']]
        n = iters[name] * vmb
        check(len(inside) >= n,
              f'recipe simulated {name}: {len(inside)} timed steps')
        steps = inside[-n:]
        stage_steps[name] = {
            'steps_an_iteration': vmb,
            'ms_per_step': {'median': statistics.median(steps),
                            'min': min(steps), 'max': max(steps)},
            'ms_per_iteration': [sum(steps[i:i + vmb])
                                 for i in range(0, n, vmb)]}
    # storage: the stages in bf16 at H 64, the CTC recognizer in f32 at H 48
    check(all((dtype, H) == ((F32, 48) if stage.startswith('ctc')
                             else (BF16, 64))
              for (_, _, _, _, H, dtype), stage in shapes.seen.items()),
          f'recipe simulated: storage and widths by stage {shapes.seen}')
    # the evaluations
    results = {}
    for name in RECIPE_SIM_EVALS:
        (entry,) = stages[f'eval {name}']
        summary = entry['metrics']['summary']
        records = entry['metrics']['per_recording']
        launches = entry['launches']
        check(summary['num_recordings'] == RECIPE_SIM['eval_examples']
              and math.isfinite(summary.get('mean_der', math.nan))
              and all('num_segments' in r for r in records)
              and (name == 'tsvad' or 'mean_cp_wer' in summary),
              f'recipe simulated eval {name}: {summary}')
        check(math.isfinite(summary.get('mean_si_sdr', math.nan))
              or name == 'tsvad' or summary.get('degenerate_reasons'),
              f'recipe simulated eval {name}: SI-SDR or a reason, {summary}')
        check(launches['blstm_fullfused_fwd'] > 0
              and not any(v for k, v in launches.items()
                          if k != 'blstm_fullfused_fwd'),
              f'recipe simulated eval {name}: launches {launches}')
        n = summary['num_recordings']
        results[name] = {
            'summary': summary, 'launches': launches,
            's_per_recording': entry['seconds'] / n,
            'transcribe_s_per_recording': entry['transcribe_s'] / n,
            'transcribe_share': entry['transcribe_s'] / entry['seconds'],
            'stage_ms': [r['stage_ms'] for r in records]}
    out = {
        'seconds': seconds, 'peak_mib': peak,
        'simulate_s': stage_names['ctc']['start'] - t0,
        'ctc': {'seconds': stage_names['ctc']['seconds'],
                'ms_per_step': step_ms,
                'corpus_s': ctc_steps[0][0] - stage_names['ctc']['start'],
                'transcribe_alone': oracle,
                'losses': losses[::10] + losses[-1:],
                'launches': stage_names['ctc']['launches']},
        **{name: {'seconds': stage_names[name]['seconds'],
                  **stage_steps[name], 'profiled_step': profiled[name],
                  'launches': stage_names[name]['launches']}
           for name in ('tsvad', 'tssep')},
        'evals': results,
        'shards': counts,
        'shapes': [[name, *key[:4], str(key[4]).split('.')[-1], stage]
                   for (name, *key), stage in shapes.seen.items()],
    }
    log(f'recipe simulated: {json.dumps(out)}')
    _recipe_sim_kernel_checks(rows, shapes.seen)
    return out


def _recipe_sim_kernel_checks(rows, seen):
    """The fully fused pair against its plain versions at each (rows, F,
    H, storage) the phase launched, at the longest T it launched there: in
    bf16 (the stages, H 64) to ``CLUSTER_TOL``, in f32 (the CTC, H 48) to
    the f32 gates; and at ``CTC_CASES``."""
    gen = torch.Generator(device='cuda').manual_seed(16)
    longest = {}
    for (name, B, T, F, H, dtype), stage in seen.items():
        key = (name, B, F, H, dtype)
        if T > longest.get(key, (0, None))[0]:
            longest[key] = (T, stage)
    cases = sorted(longest.items(), key=lambda kv: (kv[0][0], str(kv[0][4]),
                                                    kv[0][1], kv[0][2]))
    for (name, B, F, H, dtype), (T, stage) in cases:
        case_fn = (fullfused_case if name == 'blstm_fullfused_fwd'
                   else fullfused_bwd_case)
        with torch.set_grad_enabled(name.endswith('_bwd')):
            rows[name].append(case_fn(f'recipe sim {stage}', B, T, F, H,
                                      dtype, gen))
        log(json.dumps(rows[name][-1]))
        torch.cuda.empty_cache()
    for label, names, B, T, F, H in CTC_CASES:
        for name in names:
            if longest.get((name, B, F, H, F32), (0,))[0] >= T:
                continue
            case_fn = (fullfused_case if name == 'blstm_fullfused_fwd'
                       else fullfused_bwd_case)
            with torch.set_grad_enabled(name.endswith('_bwd')):
                rows[name].append(case_fn(label, B, T, F, H, F32, gen))
            log(json.dumps(rows[name][-1]))


#: serve streaming: the flagship (bf16, bf16 head) on one stream of
#: ``STREAM_SECONDS`` of 16 kHz audio fed in blocks of ``STREAM_BLOCK``
#: samples, chunks of ``STREAM_CHUNK`` frames with ``STREAM_LOOKAHEAD``
#: frames of lookahead, audio emitted; its first ``STREAM_CHECK_SECONDS``
#: against the plain versions, and a covering lookahead in float32 against
#: the offline forward.
STREAM_SECONDS, STREAM_BLOCK, STREAM_CHECK_SECONDS = 60, 4000, 10
STREAM_RATE = 16000
#: The streamed layers: pre_net, birnn0, birnn1, birnn2.
STREAM_LAYERS = 4
#: Covering lookahead in float32 against ``Model.forward`` on the same
#: causal frames: the same f32 sums in other orders (cuBLAS projections and
#: the one-direction first design against the fully fused kernel's), through
#: four layers.
STREAM_OFFLINE_ATOL = 1e-4
#: The Kaldi-input TS-VAD model of ``tests/test_kaldi.py:113-141`` (KaldiMFCC
#: 13 ceps at 8 kHz, units 2, projs 3, 't'): its features on the card
#: (``features/kaldi.py``'s torch path), every layer fully fused.
KALDI_TSVAD = {
    'fe': {'factory': 'tssep_tpu.features.kaldi.KaldiMFCC',
           'sample_frequency': 8000.0, 'num_ceps': 13, 'num_mel_bins': 23},
    'reader': {'sample_rate': 8000, 'aux_size': 33},
    'loss': {'factory': 'tssep_tpu.tasks.losses.VADSigmoidBCE'},
    'mask_estimator': {
        'idim': 13, 'odim': 1, 'units': 2, 'projs': 3,
        'aux_net_output_size': 33, 'num_averaged_permutations': 1,
        'output_resolution': 't'}}


def _stream_input(seconds, seed=0):
    """``seconds`` of audio and the 8 speakers' embeddings (513), numpy,
    from ``seed``."""
    rng = np.random.default_rng(seed)
    samples = (0.1 * rng.standard_normal(seconds * STREAM_RATE)).astype(
        np.float32)
    return samples, rng.uniform(0, 1, (SPEAKERS, BINS)).astype(np.float32)


def _stream(session, samples):
    """Feeds ``samples`` in blocks of ``STREAM_BLOCK`` and flushes; returns
    the chunks and the ms of each (from asking for it to its arrival on the
    host, CUDA-synchronized)."""
    chunks, ms = [], []

    def drain(gen):
        while True:
            t0 = time.perf_counter()
            try:
                chunk = next(gen)
            except StopIteration:
                return
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            chunks.append(chunk)

    for i in range(0, len(samples), STREAM_BLOCK):
        drain(session.process(samples[i:i + STREAM_BLOCK]))
    drain(session.flush())
    return chunks, ms


def _stream_stages(session):
    """Wraps the session's stages (``_stft_more``, ``_features``,
    ``_block_fn``, ``_synthesize``) to sum their ms, each ending in a CUDA
    synchronize; returns the sums, filled as the session runs."""
    stage_ms = {}
    for name in ('_stft_more', '_features', '_block_fn', '_synthesize'):
        def timed(*args, _fn=getattr(session, name), _name=name[1:], **kw):
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            stage_ms[_name] = (stage_ms.get(_name, 0.0)
                               + 1e3 * (time.perf_counter() - t0))
            return out
        setattr(session, name, timed)
    return stage_ms


def _stream_blocks(frames, chunk, lookahead):
    """The blocks a session cuts ``frames`` into: (block frames, split)."""
    blocks, pos = [], 0
    while pos < frames:
        length = min(chunk + lookahead, frames - pos)
        blocks.append((length, min(chunk, length)))
        pos += blocks[-1][1]
    return blocks


def _session(model, aux, lookahead=STREAM_LOOKAHEAD):
    return streaming.StreamingSession(
        model, aux, chunk_frames=STREAM_CHUNK, lookahead_frames=lookahead,
        emit_audio=True)


def _stream_agreement(got, want):
    """Max abs error of the masks and of the audio over its peak, chunk
    by chunk."""
    mask_err = max(float(np.abs(g[0] - w[0]).max()) for g, w in zip(got, want))
    peak = max(float(np.abs(w[2]).max()) for w in want)
    wave_err = max(float(np.abs(g[2] - w[2]).max())
                   for g, w in zip(got, want)) / peak
    return mask_err, wave_err


def _kaldi_serve():
    """The Kaldi-input TS-VAD model serves one batch (2 x 2 s, 2 channels,
    reference channel 1, 4 speakers) on the card, its features made there,
    the launch counts set to 0 just before; its logits against the plain
    versions, in bf16 and f32 storage."""
    rng = np.random.default_rng(0)
    ex = {'observation': torch.from_numpy(rng.standard_normal(
              (2, 2, 16000)).astype(np.float32)).cuda(),
          'auxInput': torch.from_numpy(rng.standard_normal(
              (2, 4, 33)).astype(np.float32)).cuda(),
          'reference_channel': 1}
    out = {}
    for dtype in (BF16, F32):
        model = _model(KALDI_TSVAD, dtype)
        check(type(model.fe).__name__ == 'KaldiMFCC'
              and not hasattr(model.fe, 'stft'), 'a waveform extractor')
        _reset_launches()
        got = model(ex)
        torch.cuda.synchronize()
        launches = _launches()
        want = _plain_forward(model, ex)
        frames = model.fe.num_frames(16000)
        check(tuple(got.logit.shape) == (2, 4, 1, frames, 1),
              f'kaldi logits {tuple(got.logit.shape)}')
        check(bool(torch.isfinite(got.logit).all()), 'kaldi: finite logits')
        err = (got.mask - want.mask).abs().max().item()
        logit_err = (got.logit - want.logit).abs().max().item()
        log(f'serve kaldi {dtype}: KaldiMFCC on the card, {frames} frames, '
            f'launches {launches}; mask max abs err {err:.3g}, logit max abs '
            f'err {logit_err:.3g} against the plain versions (tolerance '
            f'{SERVE_ATOL[dtype]} on the masks)')
        check(err <= SERVE_ATOL[dtype], f'kaldi {dtype} masks')
        check(launches == _expect({'blstm_fullfused_fwd': 4}, 1),
              f'kaldi: 4 fully fused launches, got {launches}')
        out[str(dtype).split('.')[-1]] = {'launches': launches,
                                          'mask_err': err,
                                          'logit_err': logit_err}
    return out


def phase_serving_streaming():
    """``StreamingSession`` on the flagship (bf16 storage, bf16 head, random
    weights from seed 0): one 60 s stream fed in blocks of 4,000 samples,
    chunks of 50 frames, lookahead 12, audio emitted. ms a chunk, the
    real-time factor, the launches (``lstm_fwd`` 3 a layer and block, 2
    where a block has no lookahead left; nothing else), the peak memory.
    Checks: the first 10 s against the same session through the plain
    versions (masks and audio, ``CLUSTER_TOL['lstm_fwd']``); in float32 a
    covering lookahead against ``Model.forward`` on the same causal frames
    (1e-4); the Kaldi-input TS-VAD model served against the plain
    versions. (``lstm_fwd`` from a nonzero state against its plain version
    at the session's shapes: the kernels phase's stream cases.)"""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _flagship()
    samples, aux = _stream_input(STREAM_SECONDS)
    check_samples = samples[:STREAM_CHECK_SECONDS * STREAM_RATE]
    _stream(_session(model, aux), samples[:2 * STREAM_BLOCK])   # warm-up
    torch.cuda.synchronize()

    session = _session(model, aux)
    frames = (len(samples) - model.fe.window_length) // model.fe.shift + 1
    blocks = _stream_blocks(frames, STREAM_CHUNK, STREAM_LOOKAHEAD)
    want_launches = STREAM_LAYERS * sum(3 if n > split else 2
                                        for n, split in blocks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _reset_launches()
    t0 = time.perf_counter()
    chunks, ms = _stream(session, samples)
    wall = time.perf_counter() - t0
    launches = _launches()
    peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
    check(len(chunks) == len(blocks), f'{len(blocks)} chunks, got '
          f'{len(chunks)}')
    check(launches == {name: want_launches if name == 'lstm_fwd' else 0
                       for name in KERNELS},
          f'streaming: {want_launches} lstm_fwd launches and no other, '
          f'got {launches}')
    emitted = sum(m.shape[-2] for m, _, _ in chunks)
    audio = np.concatenate([a for _, _, a in chunks], axis=-1)
    check(emitted == frames, f'{frames} frames emitted, got {emitted}')
    check(audio.shape == (SPEAKERS, (frames - 1) * model.fe.shift
                          + model.fe.window_length),
          f'streamed audio {audio.shape}')
    check(all(np.isfinite(m).all() and np.isfinite(a).all()
              for m, _, a in chunks), 'finite masks and audio')
    rtf = wall / STREAM_SECONDS
    staged = _session(model, aux)
    stage_ms = _stream_stages(staged)
    _, staged_ms = _stream(staged, samples)
    stage_ms['rest'] = sum(staged_ms) - sum(stage_ms.values())
    stats = {'p50': statistics.median(ms),
             'p95': float(np.percentile(ms, 95)), 'max': max(ms)}
    log(f'serve streaming: {STREAM_SECONDS} s at {STREAM_RATE} Hz in blocks '
        f'of {STREAM_BLOCK} samples, {_head(model)}, chunk {STREAM_CHUNK} '
        f'lookahead {STREAM_LOOKAHEAD} frames: {len(chunks)} chunks, ms a '
        f'chunk {json.dumps(stats)}, {wall:.3f} s in all, real-time factor '
        f'{rtf:.4f}, launches {launches} ({3 * STREAM_LAYERS} a block with '
        f'its lookahead, {2 * STREAM_LAYERS} without), peak memory over the '
        f'weights {peak:.2f} MiB')
    log(f'serve streaming: ms by stage over the stream, each synchronized '
        f'(the chunks\' ms summed, a second run): '
        f'{json.dumps(stage_ms)}')

    # 1. the kernels against the plain versions, bf16, first 10 s
    got, _ = _stream(_session(model, aux), check_samples)
    with mock.patch.object(streaming, 'lstm_fwd', kb.lstm_fwd_plain):
        want, _ = _stream(_session(model, aux), check_samples)
    mask_err, wave_err = _stream_agreement(got, want)
    tol = CLUSTER_TOL['lstm_fwd']
    log(f'serve streaming bf16: kernels against the plain versions on '
        f'{STREAM_CHECK_SECONDS} s ({len(got)} chunks): mask max abs err '
        f'{mask_err:.3g}, audio max abs err / peak {wave_err:.3g} '
        f'(tolerance {tol})')
    check(len(got) == len(want), 'as many chunks through the plain versions')
    check(mask_err <= tol, f'streamed masks against the plain versions '
          f'{mask_err:.3g}')
    check(wave_err <= tol, f'streamed audio against the plain versions '
          f'{wave_err:.3g}')

    # 2. float32, a covering lookahead: the offline forward's masks
    model32 = _flagship(F32)
    model32.load_state_dict(model.state_dict())
    covering = _session(model32, aux, lookahead=10 ** 6)
    streamed, _ = _stream(covering, check_samples)
    reference = _session(model32, aux)
    reference._sample_buf = check_samples
    reference._stft_more()
    causal = reference._frame_buf
    feats = reference._features(causal).astype(np.float32)
    offline = model32({
        'Input': torch.from_numpy(feats[None]).cuda(),
        'Observation': torch.from_numpy(
            causal[None, None].astype(np.complex64)).cuda(),
        'auxInput': torch.from_numpy(aux[None]).cuda(),
        'reference_channel': 0}).mask[0].float().cpu().numpy()
    masks = np.concatenate([m for m, _, _ in streamed], axis=-2)
    check(masks.shape == offline.shape, f'covering: {masks.shape} against '
          f'{offline.shape}')
    offline_err = float(np.abs(masks - offline).max())
    log(f'serve streaming f32: covering lookahead ({len(streamed)} chunks) '
        f'against Model.forward on the same causal frames: mask max abs err '
        f'{offline_err:.3g} (tolerance {STREAM_OFFLINE_ATOL})')
    check(offline_err <= STREAM_OFFLINE_ATOL,
          f'covering lookahead against offline {offline_err:.3g}')

    # 3. lstm_fwd from a carried state: the kernels phase's stream cases
    # 4. the Kaldi-input TS-VAD model on the card
    kaldi = _kaldi_serve()
    return {'launches': launches, 'chunks': len(chunks), 'ms': stats,
            'ms_all': ms, 'wall_s': wall, 'real_time_factor': rtf,
            'peak_mib': peak, 'head': _head(model), 'stage_ms': stage_ms,
            'agreement': {'plain bf16': {'mask_err': mask_err,
                                         'wave_err': wave_err},
                          'offline f32': offline_err},
            'kaldi': kaldi}


#: The distributed phase: 2 ranks share the card (gloo: NCCL refuses two
#: ranks on one device), each with half of the batch-16 global batch.
DIST_RANKS = 2
#: Seconds: a collective that waits longer raises; ranks that take longer
#: are killed.
DIST_COLLECTIVE_TIMEOUT, DIST_DEADLINE = 300, 600
#: The chunk-sharded eval's recording (1 channel) and the calibration set.
DIST_EVAL_SECONDS, DIST_CALIBRATION = 20, 8
#: 2 ranks against one process. Against the same computation in one
#: process (each global batch as the ranks' two batches of 8, their flat
#: gradient buffers added): bit for bit, a sum of two terms being the same
#: in either order. Against the one-process run at batch 16: losses at rtol
#: 1e-3 in bf16 (JAX's 1e-5, ``tests/test_multihost.py:90-103``, holds in
#: f32: at 8 rows the GEMMs and the kernels tile otherwise than at 16, so
#: the bf16 activations round otherwise, ~4e-5 of a loss on the card, well
#: under bf16's 2^-8), parameters at JAX's rtol 2e-2 and atol 3e-3 (Adam's
#: 1/sqrt(v) turns a near-zero gradient's rounding into a step of lr).
DIST_LOSS_RTOL, DIST_PARAM_RTOL, DIST_PARAM_ATOL = 1e-3, 2e-2, 3e-3
DIST_PER_STEP = {'blstm_fullfused_fwd': 3, 'blstm_bidi_fwd': 1,
                 'blstm_fullfused_bwd': 3, 'blstm_bidi_bwd': 1}


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _dist_data(model, shard=None):
    sim = DeviceMeetingSimulator(duration=SAMPLES / 16000,
                                 num_speakers=SPEAKERS, aux_size=BINS)
    return DeviceSimDataset(sim, TRAIN_BATCH, seed=2,
                            targets=model.loss.device_targets() | {'Vad'},
                            device='cuda', shard=shard)


def _dist_trainer(model, mesh=None):
    return Trainer(model, None, optimizer=Adam(gradient_clipping=10,
                                               lr=1e-3), seed=0, mesh=mesh)


def _grad_buffer(trainer):
    """A buffer of the size the step all-reduces: every gradient and the
    loss, float32."""
    return torch.zeros(sum(p.numel() for p in trainer.optimizer.params) + 1,
                       device='cuda')


def _host_ms(fn, reps):
    """ms of ``fn`` (which ends in a synchronize) by the host's clock,
    after one warm-up call: the median and every call."""
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times), times


def _dist_recording():
    ex = dummy_example(1, 16_000 * DIST_EVAL_SECONDS, SPEAKERS, 1,
                       aux_size=BINS)
    return ex['audio_data']['observation'], ex['auxInput']


def _calibration_set():
    rng = np.random.default_rng(0)
    refs = [rng.random((SPEAKERS, 400)) > 0.7
            for _ in range(DIST_CALIBRATION)]
    acts = [0.25 + 0.2 * r + 0.05 * rng.standard_normal(r.shape)
            for r in refs]
    return acts, refs


def _dist_chunked(model, mesh=None):
    """The chunked masks and activity of the recording, with the launch
    counts set to 0 just before; (masks, activity, launches)."""
    obs, aux = _dist_recording()
    chunked = eval_driver.ChunkedMaskEstimator(
        model, chunk_frames=EVAL_CHUNK, hop_frames=EVAL_HOP, mesh=mesh)
    stft = eval_driver.EvalDriver(model).stft(obs)
    _reset_launches()
    masks, activity = chunked(stft, aux)
    torch.cuda.synchronize()
    return masks, activity, _launches()


def _dist_rank(rank, port, out_dir):
    """One of ``DIST_RANKS`` processes sharing the card: trains its half of
    each batch-16 step for ``TRAIN_STEPS`` steps (the launch counts set to
    0 just before), times further steps and the gradient all-reduce, runs
    its chunks of the recording's forward calls and its share of the
    calibration; writes what it found to ``<out_dir>/rank<rank>.pt``."""
    from tssep_tpu_torch.dist import mesh as mesh_lib
    from tssep_tpu_torch.dist import multihost
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(f'127.0.0.1:{port}', DIST_RANKS, rank,
                         backend='gloo', timeout=DIST_COLLECTIVE_TIMEOUT)
    out = {'backend': multihost.backend(), 'world': multihost.process_count()}
    model = _flagship()
    trainer = _dist_trainer(model, {'data': DIST_RANKS})
    trainer.ensure_init()
    data = _dist_data(model, trainer.mesh.shard)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    out['losses'] = trainer.train_steps(data, TRAIN_STEPS)
    out['launches'] = _launches()
    out['peak_mib'] = torch.cuda.max_memory_allocated() / 2 ** 20
    if rank == 0:
        out['params'] = {k: v.detach().float().cpu().clone() for k, v in
                         model.state_dict().items()}
    out['local_batch'] = next(iter(data))['observation'].shape[0]
    steps = iter(data)

    def step():
        trainer.train_step(next(steps))
        torch.cuda.synchronize()
    out['step_ms'] = _host_ms(step, TRAIN_STEPS)
    buf = _grad_buffer(trainer)

    def reduce():
        multihost.all_reduce(buf)
        torch.cuda.synchronize()
    out['allreduce_ms'] = _host_ms(reduce, 10)
    out['allreduce_mib'] = buf.numel() * 4 / 2 ** 20
    mesh = mesh_lib.make_mesh()
    out['chunked'] = _dist_chunked(_flagship(), mesh)
    acts, refs = _calibration_set()
    out['calibration'] = eval_driver.calibrate_threshold(
        acts[rank::DIST_RANKS], refs[rank::DIST_RANKS])
    torch.save(out, Path(out_dir) / f'rank{rank}.pt')
    torch.distributed.destroy_process_group()


def _spawn_ranks(out_dir):
    """Starts ``DIST_RANKS`` processes (the spawn method) on ``_dist_rank``
    and waits for them; a failing rank takes the others down, late ranks
    are killed."""
    import torch.multiprocessing as mp
    context = mp.start_processes(
        _dist_rank, args=(_free_port(), str(out_dir)), nprocs=DIST_RANKS,
        join=False, start_method='spawn')
    deadline = time.monotonic() + DIST_DEADLINE
    try:
        while not context.join(timeout=1):
            check(time.monotonic() < deadline,
                  f'distributed: ranks still running after {DIST_DEADLINE} s')
    finally:
        for p in context.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    return [torch.load(Path(out_dir) / f'rank{r}.pt', weights_only=False)
            for r in range(DIST_RANKS)]


def _shards_in_one_process():
    """(b)'s computation without a collective: each global batch of 16
    as the ranks' two batches of 8 with their rows' draws, each's
    gradients and loss flattened as the trainer flattens them and summed,
    one clipped Adam update; (losses, parameters)."""
    from tssep_tpu_torch.dist.mesh import RowShard
    from tssep_tpu_torch.train.trainer import step_generator
    model = _flagship()
    trainer = _dist_trainer(model)
    shards = [RowShard(r, DIST_RANKS) for r in range(DIST_RANKS)]
    batches = [iter(_dist_data(model, shard)) for shard in shards]
    local = TRAIN_BATCH // DIST_RANKS
    losses = []
    for step in range(TRAIN_STEPS):
        total = None
        for shard, data in zip(shards, batches):
            trainer.optimizer.zero_grad()
            gen = step_generator('cuda', trainer.seed, step, 0, shard=shard,
                                 examples=local)
            loss, _ = model.loss_fn(next(data), gen, training=True)
            loss.backward()
            grads = [p.grad for p in trainer.optimizer.params
                     if p.grad is not None]
            flat = torch.cat([g.reshape(-1).float() for g in grads]
                             + [loss.detach().reshape(1).float()])
            total = flat if total is None else total + flat
        with torch.no_grad():
            for g, value in zip(grads, total.split(
                    [g.numel() for g in grads] + [1])):
                g.copy_(value.view_as(g))
        trainer.optimizer.step()
        losses.append(total[-1].item())
    return losses, {k: v.detach().clone() for k, v in
                    model.state_dict().items()}


def _param_err(got, want):
    """(max abs err, max err over rtol * |want| + atol) of two state
    dicts."""
    abs_err, ratio = 0.0, 0.0
    for k, w in want.items():
        w = w.float().cpu()
        d = (got[k].float().cpu() - w).abs()
        abs_err = max(abs_err, d.max().item())
        ratio = max(ratio, (d / (DIST_PARAM_RTOL * w.abs()
                                 + DIST_PARAM_ATOL)).max().item())
    return abs_err, ratio


def phase_distributed():
    """Data parallelism through ``torch.distributed`` at the flagship's
    width (bf16, bf16 head), batch 16. (a) One NCCL rank in this process:
    ``Trainer(mesh={'data': 1})`` trains 3 steps through the kernels (the
    launch counts) against the run without a mesh on the same batches,
    bit for bit; ms a step, ms of the gradient all-reduce, peak MiB. (b)
    Two ranks share the card (gloo), each with its 8 rows of each global
    batch of 16: bit for bit the same two batches of 8 in one process, and
    against the one-process run at batch 16 at ``DIST_LOSS_RTOL`` and
    JAX's parameter bounds; ms a step, ms of the all-reduce, peak MiB per
    rank. (c)
    The chunk-sharded eval of a 20 s recording on the two ranks against
    ``mesh=None``, and the calibration with half the set on each against
    one process on all of it."""
    from tssep_tpu_torch.dist import multihost
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()

    # the reference: one process, no mesh
    ref_model = _flagship()
    ref = _dist_trainer(ref_model)
    ref_losses = ref.train_steps(_dist_data(ref_model), TRAIN_STEPS)
    ref_params = {k: v.detach().clone() for k, v in
                  ref_model.state_dict().items()}
    split_losses, split_params = _shards_in_one_process()

    # (a) one NCCL rank
    multihost.initialize(f'127.0.0.1:{_free_port()}', 1, 0, backend='nccl',
                         timeout=DIST_COLLECTIVE_TIMEOUT)
    check(multihost.backend() == 'nccl', 'distributed: an NCCL group')
    model = _flagship()
    trainer = _dist_trainer(model, {'data': 1})
    trainer.ensure_init()
    data = _dist_data(model, trainer.mesh.shard)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    losses = trainer.train_steps(data, TRAIN_STEPS)
    launches = _launches()
    peak_one = torch.cuda.max_memory_allocated() / 2 ** 20
    check(launches == _expect(DIST_PER_STEP, TRAIN_STEPS),
          f'distributed 1 rank: per step {DIST_PER_STEP}, got {launches}')
    bits = losses == ref_losses and all(
        torch.equal(v, ref_params[k]) for k, v in model.state_dict().items())
    one_err = _param_err(model.state_dict(), ref_params)
    log(f'distributed 1 rank (NCCL, mesh data 1), bf16, {_head(model)}: '
        f'losses {losses} against {ref_losses} without a mesh; bit for bit: '
        f'{bits}; parameters max abs err {one_err[0]:.3g}; launches '
        f'{launches}')
    check(bits, 'distributed 1 rank: the run without a mesh, bit for bit')
    steps = iter(data)

    def step():
        trainer.train_step(next(steps))
        torch.cuda.synchronize()
    step_one = _host_ms(step, TRAIN_STEPS)
    buf = _grad_buffer(trainer)
    nccl_ms = cuda_ms(lambda: multihost.all_reduce(buf), reps=10)
    torch.distributed.destroy_process_group()
    del trainer, model, ref, ref_model, data, steps
    torch.cuda.empty_cache()

    # (c)'s references, before the ranks share the card
    eval_model = _flagship()
    want_masks, want_activity, _ = _dist_chunked(eval_model)
    del eval_model
    acts, refs = _calibration_set()
    want_calibration = eval_driver.calibrate_threshold(acts, refs)

    # (b) and (c): two ranks
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='tssep_dist_') as tmp:
        ranks = _spawn_ranks(tmp)
    wall = time.perf_counter() - t0
    for r, got in enumerate(ranks):
        check((got['backend'], got['world']) == ('gloo', DIST_RANKS),
              f'distributed rank {r}: {got["backend"]}, {got["world"]}')
        check(got['local_batch'] == TRAIN_BATCH // DIST_RANKS,
              f'distributed rank {r}: local batch {got["local_batch"]}')
        check(got['launches'] == _expect(DIST_PER_STEP, TRAIN_STEPS),
              f'distributed rank {r}: launches {got["launches"]}')
        check(got['losses'] == ranks[0]['losses'],
              f'distributed rank {r}: the losses of rank 0')
    split_bits = ranks[0]['losses'] == split_losses and all(
        torch.equal(ranks[0]['params'][k], v.float().cpu())
        for k, v in split_params.items())
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(ranks[0]['losses'], ref_losses))
    abs_err, ratio = _param_err(ranks[0]['params'], ref_params)
    split_loss_err = max(abs(a - b) / abs(b) for a, b in
                         zip(split_losses, ref_losses))
    split_abs_err, _ = _param_err(split_params, ref_params)
    log(f'distributed {DIST_RANKS} ranks (gloo, one card), batch '
        f'{TRAIN_BATCH // DIST_RANKS} each of {TRAIN_BATCH}: losses '
        f'{ranks[0]["losses"]}; bit for bit the same shards in one process '
        f'({split_losses}): {split_bits}; against batch {TRAIN_BATCH} in one '
        f'process ({ref_losses}): max rel err {loss_err:.3g} (rtol '
        f'{DIST_LOSS_RTOL}), parameters max abs err {abs_err:.3g}, max err '
        f'/ (rtol |p| + atol) {ratio:.3g} (rtol {DIST_PARAM_RTOL}, atol '
        f'{DIST_PARAM_ATOL}); the shards in one process against batch '
        f'{TRAIN_BATCH}: {split_loss_err:.3g}, {split_abs_err:.3g}; '
        f'{wall:.1f} s wall')
    check(split_bits, 'distributed: the same shards in one process, bit '
          'for bit')
    check(loss_err <= DIST_LOSS_RTOL, 'distributed: losses of one process')
    check(ratio <= 1, 'distributed: parameters of one process')

    mask_err = max(float(np.abs(r['chunked'][0] - want_masks).max())
                   for r in ranks)
    act_err = max(float(np.abs(r['chunked'][1] - want_activity).max())
                  for r in ranks)
    eval_launches = [r['chunked'][2] for r in ranks]
    log(f'distributed eval: {DIST_EVAL_SECONDS} s recording, chunks dealt '
        f'over {DIST_RANKS} ranks against mesh=None: masks max abs err '
        f'{mask_err:.3g}, activity {act_err:.3g} (tolerance '
        f'{SERVE_ATOL[BF16]}); launches by rank {eval_launches}; '
        f'calibration by rank {[r["calibration"] for r in ranks]} against '
        f'{want_calibration} in one process')
    check(mask_err <= SERVE_ATOL[BF16] and act_err <= SERVE_ATOL[BF16],
          'distributed eval: the masks of mesh=None')
    check(all(r['calibration'][0] == want_calibration[0]
              and math.isclose(r['calibration'][1], want_calibration[1],
                               rel_tol=1e-12) for r in ranks),
          'distributed calibration: the threshold of one process')
    for launched in eval_launches:
        check(launched['blstm_fullfused_fwd'] > 0
              and launched['blstm_bidi_fwd'] > 0,
              f'distributed eval: launches {launched}')

    numbers = {
        'card': card,
        'step_ms': {'1 rank (NCCL), batch 16': step_one[0],
                    f'{DIST_RANKS} ranks (gloo), batch 8 each': max(
                        r['step_ms'][0] for r in ranks)},
        'step_ms_all': {'1 rank': step_one[1],
                        'by rank': [r['step_ms'][1] for r in ranks]},
        'allreduce_ms': {'1 rank (NCCL)': nccl_ms,
                         f'{DIST_RANKS} ranks (gloo, through the host)': max(
                             r['allreduce_ms'][0] for r in ranks)},
        'allreduce_mib': ranks[0]['allreduce_mib'],
        'peak_mib': {'1 rank': peak_one,
                     'by rank': [r['peak_mib'] for r in ranks]},
        'agreement': {'1 rank bit for bit': bits,
                      '2 ranks, the shards in one process, bit for bit':
                          split_bits,
                      '2 ranks loss rel err': loss_err,
                      '2 ranks param abs err': abs_err,
                      'shards in one process loss rel err': split_loss_err,
                      'shards in one process param abs err': split_abs_err,
                      'eval mask err': mask_err, 'eval activity err': act_err},
    }
    log(f'distributed ({card}): {json.dumps(numbers)}')
    return {'launches': launches,
            **{f'launches rank {r}': got['launches']
               for r, got in enumerate(ranks)},
            **{f'eval launches rank {r}': got for r, got in
               enumerate(eval_launches)},
            **numbers}


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
        stream = [r for r in calls if ' stream ' in r['name']
                  and r['dtype'] == 'bfloat16']
        if stream:
            # one streamed block: each stream case twice (pre_net and
            # birnn2 on 1 row, birnn0 and birnn1 on 8)
            extra['stream_block'] = {
                k: (None if any(r.get(k) is None for r in stream)
                    else 2 * sum(r[k] for r in stream))
                for k in ('ms', 'plain_ms', 'bound_ms', 'library_ms',
                          'first_design_ms')}
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
    with tempfile.TemporaryDirectory(prefix='tssep_recipe_') as tmp:
        recipe = phase_recipe_cli(Path(tmp))
        log(f'-- recipe cli done at {time.perf_counter() - t0:.1f} s')
        recipe_flagship = phase_recipe_cli_flagship()
        log(f'-- recipe cli flagship done at {time.perf_counter() - t0:.1f} s')
        evaluated = phase_eval_flagship()
        log(f'-- eval flagship done at {time.perf_counter() - t0:.1f} s')
        evaluated_cli = phase_eval_cli(Path(tmp) / 'warm')
        log(f'-- eval cli done at {time.perf_counter() - t0:.1f} s')
    recipe_sim = phase_recipe_simulated(rows)
    log(f'-- recipe simulated done at {time.perf_counter() - t0:.1f} s')
    streamed = phase_serving_streaming()
    log(f'-- serve streaming done at {time.perf_counter() - t0:.1f} s')
    distributed = phase_distributed()
    log(f'-- distributed done at {time.perf_counter() - t0:.1f} s')
    log(json.dumps({'serving cond_fuse': serving_cond, 'training': training,
                    **switched, 'recipe cli': recipe,
                    'recipe cli flagship': recipe_flagship,
                    'eval flagship': evaluated, 'eval cli': evaluated_cli,
                    'recipe simulated': recipe_sim,
                    'serve streaming': {k: v for k, v in streamed.items()
                                        if k != 'ms_all'},
                    'distributed': {k: v for k, v in distributed.items()
                                    if 'launches' not in k}}))
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
        **{label: r['launches'] for label, r in switched.items()},
        **{f'recipe cli {name}': recipe[name]['launches']
           for name in ('tsvad', 'tssep warm', 'tssep cold')},
        'recipe cli flagship': recipe_flagship['launches'],
        **{f'eval flagship {name}': evaluated[name]['launches']
           for name in ('beamform', 'masking')},
        **{f'eval cli {name}': evaluated_cli[name]['launches']
           for name in ('masking', 'beamform')},
        **{f'recipe simulated {name}': recipe_sim[name]['launches']
           for name in ('ctc', 'tsvad', 'tssep')},
        'recipe simulated transcribe':
            recipe_sim['ctc']['transcribe_alone']['launches'],
        **{f'recipe simulated eval {name}': r['launches']
           for name, r in recipe_sim['evals'].items()},
        'serve streaming': streamed['launches'],
        **{f'serve kaldi {dtype}': r['launches']
           for dtype, r in streamed['kaldi'].items()},
        'distributed 1 rank': distributed['launches'],
        **{f'distributed {key}': launched
           for key, launched in distributed.items()
           if key.startswith(('launches rank', 'eval launches rank'))}})))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
