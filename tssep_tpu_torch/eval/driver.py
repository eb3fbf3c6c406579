"""Long-recording eval driver: port of ``tssep_tpu/eval/driver.py``.
Chunked mask estimation, diarization, segment-wise beamforming,
stitching, and metrics.

1. the recording's STFT is computed once, on the model's device;
2. the features of the whole recording are computed there, then cut into
   overlapping fixed-size chunks (``Log1pMaxNormAbsSTFT`` normalises by the
   recording's maximum, so per-chunk features would change the masks),
   and the mask estimator runs on ``batch_chunks`` chunks per call through
   the port's kernels;
3. chunk masks/VAD logits come to the host (bfloat16 cast to float32 on
   the device first) and are stitched by overlap-discard;
4. frame activity is thresholded + median-smoothed into per-speaker
   ``ArrayInterval`` diarization;
5. the offline beamformer (numpy float64, on the host, on the STFT copied
   as complex64 and widened to complex128, the type of the JAX package's
   numpy STFT) or mask-multiply reconstructs each speaker, the ISTFT runs
   on the model's device, and ``istft_vad`` maps activity back to
   samples.

Host-side work (stitching, diarization, beamforming, metrics) is numpy, as
in the JAX package. Under a mesh (``dist.mesh.make_mesh``) every rank
holds the recording, each runs its rows of every forward call's chunks
and the masks are gathered (``ChunkedMaskEstimator(mesh=)``); the
calibration sums its statistics over the processes.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from tssep_tpu_torch.dist import mesh as mesh_lib
from tssep_tpu_torch.dist import multihost
from tssep_tpu_torch.eval.classic_bf import ClassicBF
from tssep_tpu_torch.eval.metrics import der
from tssep_tpu_torch.signal.intervals import ArrayInterval
from tssep_tpu_torch.signal.vad import istft_vad, stft_vad

__all__ = ['ChunkedMaskEstimator', 'diarize_from_activity', 'EvalDriver',
           'stitch_chunks', 'median_smooth', 'to_numpy', 'activity_from_sig',
           'save_wavs', 'wav_writer', 'calibration_stats',
           'calibrate_threshold']


def to_numpy(x):
    """A tensor (or array) as a host numpy array: bfloat16 and float16 are
    cast to float32 on their device before the copy; complex stays
    complex."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _chunk_starts(num_frames, chunk, hop):
    if num_frames <= chunk:
        return [0]
    starts = list(range(0, num_frames - chunk + 1, hop))
    if starts[-1] + chunk < num_frames:
        starts.append(num_frames - chunk)
    return starts


def stitch_chunks(chunks, starts, num_frames, chunk, hop, time_axis):
    """Overlap-discard stitching: interior chunks contribute their center."""
    out = None
    filled = np.zeros(num_frames, dtype=bool)
    margin = (chunk - hop) // 2
    for arr, s in zip(chunks, starts):
        arr = np.asarray(arr)
        if out is None:
            shape = list(arr.shape)
            shape[time_axis] = num_frames
            out = np.zeros(shape, dtype=arr.dtype)
        lo = 0 if s == 0 else margin
        hi = chunk if s + chunk >= num_frames else chunk - margin
        idx_out = [slice(None)] * out.ndim
        idx_in = [slice(None)] * out.ndim
        idx_out[time_axis] = slice(s + lo, s + hi)
        idx_in[time_axis] = slice(lo, hi)
        out[tuple(idx_out)] = arr[tuple(idx_in)]
        filled[s + lo:s + hi] = True
    assert filled.all(), 'stitching left gaps'
    return out


def activity_from_sig(sig, stat):
    """Frame activity from the (spk, T, F) sigmoid mask: a frequency
    statistic per frame.  ``stat``: 'mean' (the TS-SEP recipe default) or
    'qNN' (frequency quantile, e.g. 'q90')."""
    if stat.startswith('q'):
        return np.quantile(sig, float(stat[1:]) / 100, axis=-1)
    assert stat == 'mean', stat
    return sig.mean(-1)


def median_smooth(activity, kernel=11):
    """Median filter along the last axis (odd kernel)."""
    if kernel <= 1:
        return activity
    import scipy.ndimage
    return scipy.ndimage.median_filter(
        activity.astype(np.float32), size=(1,) * (activity.ndim - 1) + (kernel,)
    ) > 0.5


def diarize_from_activity(activity, threshold=0.5, smooth_kernel=11,
                          min_frames=0, merge_gap=0, pad_frames=0):
    """(spk, frames) scores -> list of per-speaker ArrayIntervals.

    ``merge_gap``: bridge silences shorter than this many frames before
    the ``min_frames`` filter — standard diarization post-processing for
    speech with in-turn pauses.

    ``pad_frames``: dilate every surviving interval by this many frames on
    both sides (onset/offset collar)."""
    act = np.asarray(activity) > threshold
    act = median_smooth(act, smooth_kernel)
    out = []
    for row in act:
        ai = ArrayInterval(row)
        ivs = ai.normalized_intervals
        if merge_gap and len(ivs) > 1:
            merged = [list(ivs[0])]
            for s, e in ivs[1:]:
                if s - merged[-1][1] < merge_gap:
                    merged[-1][1] = e
                else:
                    merged.append([s, e])
            ivs = [tuple(iv) for iv in merged]
            ai = ArrayInterval(ivs, shape=len(row))
        if min_frames:
            ivs = [iv for iv in ivs if iv[1] - iv[0] >= min_frames]
            ai = ArrayInterval(ivs, shape=len(row))
        if pad_frames and ivs:
            n = len(row)
            ai = ArrayInterval(
                [(max(0, s - pad_frames), min(n, e + pad_frames))
                 for s, e in ivs], shape=n)
        out.append(ai)
    return out


class _Stages:
    """Milliseconds per stage into ``ms``: each ``lap`` closes the stage
    since the previous one, after the device's queued work has finished."""

    def __init__(self, device, ms):
        self.cuda = torch.device(device).type == 'cuda'
        self.ms = ms
        self._sync()
        self.t = time.perf_counter()

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def lap(self, name=None):
        """Close the running stage as ``name`` (None: uncounted, timed
        elsewhere)."""
        self._sync()
        now = time.perf_counter()
        if name is not None:
            self.ms[name] = self.ms.get(name, 0.0) + 1e3 * (now - self.t)
        self.t = now


@dataclasses.dataclass
class ChunkedMaskEstimator:
    """Run the mask estimator over a long recording in fixed-size chunks.

    chunk/hop in STFT frames; ``batch_chunks`` chunks per forward call on
    the model's device (the last call padded with copies of its last chunk
    when the recording has more than one call's chunks, or under a mesh).
    ``mesh`` (``dist.mesh.Mesh``): the chunks are the data-parallel axis of
    long-recording inference (JAX :155-230); ``batch_chunks`` is rounded to
    a multiple of the data axis, every rank runs its rows of each call and
    the masks and logits are gathered, so each rank returns the whole
    recording's.
    """

    model: object
    chunk_frames: int = 316          # = 5 s at 16 kHz / 1024/256 STFT
    hop_frames: int = 158
    batch_chunks: int = 8
    mesh: object = None
    #: Frame-activity statistic over the (T, F) sigmoid mask for 'tf'
    #: output resolutions: 'mean' (the TS-SEP recipe: mask averaged over
    #: frequency) or 'qNN' (freq quantile, e.g. 'q90').  'frame'
    #: resolutions are unaffected ((T, 1) masks: every statistic is the
    #: sigmoid itself).
    activity_stat: str = os.environ.get('TSSEP_EVAL_ACTIVITY', 'mean')

    def __post_init__(self):
        if self.mesh is not None:
            if self.mesh.shape[mesh_lib.MODEL_AXIS] > 1:
                raise NotImplementedError(f'{self.mesh!r}: '
                                          f'{mesh_lib.ITEM_4B}')
            n = self.mesh.shape[mesh_lib.DATA_AXIS]
            self.batch_chunks = max(self.batch_chunks, n)
            self.batch_chunks -= self.batch_chunks % n or 0
        #: Milliseconds of the last call: 'features', 'forward' (the
        #: forward calls and their host copies) and 'stitch' (the
        #: stitching, the sigmoid and the activity, on the host).
        self.stage_ms = {}

    def __call__(self, observation_stft, aux):
        """observation_stft: (mic, T, F) complex (a tensor, or numpy);
        aux: (spk, A).

        Returns (masks (spk, nmask, T, F) float32, activity (spk, T)).
        """
        me = self.model.mask_estimator
        device = self.model.device
        self.stage_ms = {}
        stages = _Stages(device, self.stage_ms)
        obs_ref = torch.as_tensor(observation_stft[0], device=device)
        num_frames = obs_ref.shape[0]
        chunk = min(self.chunk_frames, num_frames)
        hop = min(self.hop_frames, chunk)
        starts = _chunk_starts(num_frames, chunk, hop)

        mask_chunks, logit_chunks = [], []
        with torch.inference_mode():
            feats_full = self.model.fe.stft_to_feature(obs_ref).float()
            aux = torch.as_tensor(to_numpy(aux), dtype=torch.float32,
                                  device=device)
            stages.lap('features')
            for i in range(0, len(starts), self.batch_chunks):
                batch_starts = starts[i:i + self.batch_chunks]
                feats = torch.stack([feats_full[s:s + chunk]
                                     for s in batch_starts])
                pad = self.batch_chunks - len(batch_starts)
                if pad and (len(starts) > self.batch_chunks
                            or self.mesh is not None):
                    feats = torch.cat(
                        [feats, feats[-1:].expand(pad, *feats.shape[1:])])
                if self.mesh is not None:
                    feats = feats[self.mesh.shard.rows(
                        feats.shape[0])].contiguous()
                aux_b = aux[None].expand(feats.shape[0], *aux.shape)
                out = me(feats, aux_b, training=False)
                mask, logits = out.mask, (out.logit if out.logit is not None
                                          else out.vad_logit[..., None])
                if self.mesh is not None:
                    mask = mesh_lib.gather_rows(mask.float(), self.mesh)
                    logits = mesh_lib.gather_rows(logits.float(), self.mesh)
                n = len(batch_starts)
                mask_chunks.extend(to_numpy(mask[:n]))
                logit_chunks.extend(to_numpy(logits[:n]))
        stages.lap('forward')

        masks = stitch_chunks(mask_chunks, starts, num_frames, chunk, hop,
                              time_axis=-2)
        logits = stitch_chunks(logit_chunks, starts, num_frames, chunk, hop,
                               time_axis=-2)
        # Activity score: a freq statistic OF THE SIGMOID mask, nmask
        # squeezed (default 'mean' = the TS-SEP recipe: mask averaged over
        # frequency).  For 'frame' resolution the freq axis is a
        # singleton, so any statistic equals sigmoid(logit) exactly.
        sig = 1 / (1 + np.exp(-np.squeeze(logits, axis=-3)))
        activity = activity_from_sig(sig, self.activity_stat)
        stages.lap('stitch')
        return masks, activity


@dataclasses.dataclass
class EvalDriver:
    """End-to-end long-recording evaluation on the model's device."""

    model: object
    enhancer: ClassicBF = None
    chunk_frames: int = 316
    hop_frames: int = 158
    vad_threshold: float = 0.5
    smooth_kernel: int = 11
    min_frames: int = 3
    #: Bridge sub-gap silences when diarizing (frames; 0 = off).
    merge_gap_frames: int = 0
    #: Dilate diarized intervals by this many frames per side (onset/offset
    #: collar; 0 = off).  See :func:`diarize_from_activity`.
    pad_frames: int = 0
    #: Activity statistic, forwarded to :class:`ChunkedMaskEstimator`.
    activity_stat: str = None
    #: Optional SECOND model supplying the diarization (the canonical
    #: TS-SEP deployment: the TS-VAD stage's activity drives segmentation
    #: while this driver's main model supplies the separation masks).
    dia_model: object = None

    def __post_init__(self):
        if self.enhancer is None:
            self.enhancer = ClassicBF(device=self.model.device)
        extra = ({'activity_stat': self.activity_stat}
                 if self.activity_stat else {})
        self.chunked = ChunkedMaskEstimator(
            self.model, chunk_frames=self.chunk_frames,
            hop_frames=self.hop_frames, **extra)
        self.dia_chunked = None
        if self.dia_model is not None:
            self.dia_chunked = ChunkedMaskEstimator(
                self.dia_model, chunk_frames=self.chunk_frames,
                hop_frames=self.hop_frames, **extra)

    def activity(self, obs_stft, aux):
        """Frame activity from the diarization source: the ``dia_model``
        when configured, else the main model's own mask statistic."""
        chunked = self.dia_chunked or self.chunked
        _, activity = chunked(obs_stft, aux)
        return activity

    def stft(self, observation):
        """(mic, samples) host signal -> (mic, T, F) complex64 STFT on the
        model's device."""
        return self.model.fe.stft(torch.as_tensor(
            np.asarray(observation), dtype=torch.float32,
            device=self.model.device))

    def run_recording(self, observation, aux, num_samples=None,
                      beamform=None):
        """observation: (mic, samples) float; aux: (spk, A).

        Returns dict with masks, activity, dia (frame ArrayIntervals),
        sample_dia, the (optionally beamformed) per-speaker time signals
        and ``stage_ms``, the milliseconds of each stage.
        """
        observation = to_numpy(observation)
        if observation.ndim == 1:
            observation = observation[None]
        if num_samples is None:
            num_samples = observation.shape[-1]
        stage_ms = {}
        stages = _Stages(self.model.device, stage_ms)
        obs_stft = self.stft(observation)                  # (mic, T, F)
        stages.lap('stft')

        masks, activity = self.chunked(obs_stft, aux)
        stage_ms.update(self.chunked.stage_ms)
        if self.dia_chunked is not None:
            _, activity = self.dia_chunked(obs_stft, aux)
            stage_ms.update({f'dia_{k}': v for k, v in
                             self.dia_chunked.stage_ms.items()})
        stages.lap()
        dia = diarize_from_activity(
            activity, self.vad_threshold, self.smooth_kernel,
            self.min_frames, self.merge_gap_frames, self.pad_frames)
        stages.lap('diarization')

        if beamform is None:
            beamform = observation.shape[0] >= 6
        # complex64 from the card, computed on in complex128 on the host
        # as the JAX package's numpy STFT is
        obs_host = to_numpy(obs_stft).astype(np.complex128)
        if beamform:
            est_stft = self.enhancer(masks, obs_host, dia)
        else:
            # single/few channels: masked reference channel
            est_stft = obs_host[0][None] * np.squeeze(masks, axis=-3)
            gate = np.stack([np.asarray(ai, dtype=np.float64) for ai in dia])
            est_stft = est_stft * gate[..., None]
        stages.lap('enhancer')

        est_time = to_numpy(self.model.fe.istft(
            torch.as_tensor(est_stft, device=self.model.device),
            num_samples=num_samples))
        sample_dia = istft_vad(dia, self.model.fe.window_length,
                               self.model.fe.shift, self.model.fe.fading)
        stages.lap('istft')
        return {
            'masks': masks,
            'activity': activity,
            'dia': dia,
            'sample_dia': sample_dia,
            'stft_estimate': est_stft,
            'time_estimate': est_time,
            # number of diarized (speaker, interval) segments — for
            # beamforming this is the number of segments actually
            # beamformed; 0 means the enhancer never ran and the output is
            # silence (a failed model, not a valid result).
            'num_segments': sum(len(ai.normalized_intervals) for ai in dia),
            'beamformed': bool(beamform),
            'stage_ms': stage_ms,
        }

    def score_der(self, result, reference_vad_samples):
        """DER of the estimated frame activity vs sample-domain reference."""
        ref_frames = stft_vad(np.asarray(reference_vad_samples),
                              self.model.fe.window_length,
                              self.model.fe.shift, self.model.fe.fading)
        hyp = np.stack([np.asarray(ai, dtype=bool) for ai in result['dia']])
        ref = np.asarray(ref_frames, dtype=bool)
        frames = min(ref.shape[-1], hyp.shape[-1])
        return der(ref[..., :frames], hyp[..., :frames],
                   frame_shift=self.model.fe.shift
                   / getattr(self.model.reader, 'sample_rate', 16000))

    def score_wer(self, result, reference_transcripts, transcriber,
                  sample_rate=16000):
        """cpWER of the separated streams.

        ``reference_transcripts``: one transcript (string or utterance
        list) per reference speaker; ``transcriber``: any callable
        ``(samples, sample_rate) -> str`` (``eval.wer.Transcriber``
        contract).  Each estimated stream is transcribed SEGMENT-WISE
        over its own diarization (plus a small collar) and the per-
        segment hypotheses joined in time order.  The hypothesis->reference
        speaker assignment minimizing total word errors is used (output
        order is arbitrary -> cpWER, not plain WER).  Returns the flat dict
        for metrics.json.
        """
        from tssep_tpu_torch.eval.wer import cp_wer, orc_wer
        est = np.asarray(result['time_estimate'])
        collar = int(0.12 * sample_rate)
        hyps = []
        timed_segments = []   # (start_sample, hyp) across ALL streams
        for spk, stream in enumerate(est):
            dia = result.get('sample_dia')
            if dia is not None and len(dia[spk].normalized_intervals):
                parts = []
                for s, e in dia[spk].normalized_intervals:
                    s = max(0, int(s) - collar)
                    e = min(len(stream), int(e) + collar)
                    h = transcriber(stream[s:e], sample_rate)
                    parts.append(h)
                    if h:
                        timed_segments.append((s, h))
                hyps.append(' '.join(p for p in parts if p))
            else:
                h = transcriber(stream, sample_rate)
                hyps.append(h)
                if h:
                    timed_segments.append((0, h))
        res, assignment = cp_wer(reference_transcripts, hyps,
                                 return_assignment=True)
        out = {f'wer_{k}': v for k, v in res.as_dict().items()}
        out['wer_assignment'] = assignment
        out['cp_wer'] = out.pop('wer_wer')
        # ORC-WER: the same hypotheses as unlabeled temporally-ordered
        # segments, channel attribution chosen by the segment DP.
        timed_segments.sort(key=lambda t: t[0])
        orc = orc_wer(reference_transcripts,
                      [h for _, h in timed_segments],
                      max_speakers=len(reference_transcripts))
        out['orc_wer'] = orc.error_rate
        return out


def wav_writer():
    """(name, function) of the WAV writer ``save_wavs`` uses: the native
    codec (``runtime/native.py``) when its library builds and loads, the
    python writer only when it does not."""
    from tssep_tpu_torch.runtime import native
    if native.available():
        return 'native', native.wav_write
    return 'python', _wav_write_py


def save_wavs(result, out_dir, sample_rate=16000, example_id='recording'):
    """Write per-speaker estimates as WAV files (native codec when built,
    numpy fallback otherwise).  Returns the written paths."""
    from pathlib import Path
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    est = np.asarray(result['time_estimate'], dtype=np.float32)
    _, writer = wav_writer()
    paths = []
    for spk, sig in enumerate(est):
        path = out_dir / f'{example_id}_spk{spk}.wav'
        # A WRITE failure (disk, codec bug) raises; only the unavailable
        # native extension selects the python fallback (above, once).
        writer(path, sig, sample_rate)
        paths.append(path)
    return paths


def _wav_write_py(path, sig, sample_rate):
    import struct
    sig = np.clip(np.asarray(sig, dtype=np.float32), -1, 0.999969)
    pcm = (sig * 32768.0).astype('<i2').tobytes()
    with open(path, 'wb') as f:
        f.write(b'RIFF' + struct.pack('<I', 36 + len(pcm)) + b'WAVE')
        f.write(b'fmt ' + struct.pack('<IHHIIHH', 16, 1, 1, sample_rate,
                                      sample_rate * 2, 2, 16))
        f.write(b'data' + struct.pack('<I', len(pcm)) + pcm)


def calibration_stats(activities, references, thresholds=None,
                      smooth_kernel=11, min_frames=0, merge_gap=0,
                      pad_frames=0):
    """Per-threshold (error, reference) frame totals for the local
    calibration examples.  Returns (thresholds, err, ref) float64 arrays —
    the sufficient statistic for threshold selection, additive across
    hosts."""
    if thresholds is None:
        # Low-end densified: a freq-averaged mask of frequency-sparse
        # speech legitimately peaks well below 0.5, and the silent-frame
        # floor of mask statistics sits near ~1e-3 — the grid must reach
        # below the active-frame scores without touching that floor, or
        # the optimum pins to the grid edge.
        thresholds = np.concatenate([[0.003, 0.005, 0.007],
                                     [0.01, 0.02, 0.03],
                                     np.linspace(0.05, 0.9, 18)])
    err = np.zeros(len(thresholds))
    ref_tot = np.zeros(len(thresholds))
    for i, th in enumerate(thresholds):
        for act, ref in zip(activities, references):
            hyp = np.stack([np.asarray(ai, dtype=bool)
                            for ai in diarize_from_activity(
                                act, th, smooth_kernel, min_frames,
                                merge_gap, pad_frames)])
            ref = np.asarray(ref, dtype=bool)
            frames = min(ref.shape[-1], hyp.shape[-1])
            r = der(ref[..., :frames], hyp[..., :frames])
            err[i] += r['der'] * r['total']
            ref_tot[i] += r['total']
    return np.asarray(thresholds, dtype=np.float64), err, ref_tot


def calibrate_threshold(activities, references, thresholds=None,
                        smooth_kernel=11, min_frames=0, merge_gap=0,
                        pad_frames=0, cross_host=True):
    """Pick the activity threshold minimizing DER over a calibration set.

    activities: list of (spk, frames) scores; references: list of matching
    (spk, frames) boolean frame activities.  Under ``torch.distributed``
    with more than one process (``cross_host``), the per-threshold (error,
    total) frame counts of every process's local examples are all-reduced
    before the argmin, so all processes pick the same threshold from the
    *global* calibration set; in one process this changes nothing.
    Returns (best_threshold, best_der).
    """
    ths, err, ref_tot = calibration_stats(
        activities, references, thresholds, smooth_kernel, min_frames,
        merge_gap, pad_frames)
    if cross_host and multihost.process_count() > 1:
        err, ref_tot = multihost.all_reduce_host(np.stack([err, ref_tot]))
    ders = err / np.maximum(ref_tot, 1)
    i = int(np.argmin(ders))
    # Plateau-center tie-break: mask-derived activity is near-binary after
    # post-processing, so the DER-vs-threshold curve is typically flat over
    # a wide range and a bare argmin lands on the grid edge.  Among
    # thresholds within a hair of the minimum, take the middle of the
    # contiguous plateau containing the argmin — maximally robust to
    # calibration/eval distribution shift.
    plateau_tol = ders[i] + max(0.002, 0.01 * ders[i])
    lo = hi = i
    while lo > 0 and ders[lo - 1] <= plateau_tol:
        lo -= 1
    while hi < len(ders) - 1 and ders[hi + 1] <= plateau_tol:
        hi += 1
    i = (lo + hi) // 2
    return float(ths[i]), float(ders[i])
