"""Full simulated-corpus recipe, the 'real data' rehearsal: port of
``tssep_tpu/exp/run_simulated.py``.

End-to-end, all native: simulate meetings into the shard store -> train
the CTC recognizer (with a word vocabulary) -> train TS-VAD -> warm-start +
train TS-SEP (head broadcast) -> score the eval set with the long-recording
driver (DER + SI-SDR + cpWER, WAV export).

    python -m tssep_tpu_torch.exp.run_simulated [work_dir] [--multichannel] \
        [--key=value ...] [--cpu]

``--key=value`` overrides a keyword of :func:`main` (e.g. ``--vocabulary=8
--eval_examples=8``). The recipe runs on the card; ``--cpu`` runs it on the
CPU, and without CUDA and without it the recipe raises. The stages store in
``TSSEP_COMPUTE_DTYPE`` (default bfloat16 here, as the JAX recipe's) with
their head in bfloat16 unless ``TSSEP_HEAD_BF16=0`` (the JAX recipe's
default too), and the kernel switches of
``tssep_tpu_torch.train.run.runtime_options``; the CTC recognizer stays in
float32.

This is the same shape as the reference's LibriCSS recipe (which needs its
companion repo for data prep and eval); here every stage lives in this
framework. A split whose ``<work_dir>/<split>.shard`` exists is not
simulated again, and a ``<work_dir>/ctc_asr.npz`` is loaded instead of
trained, so the recipe can run in parts on one work dir.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch

__all__ = ['main']


def _config(work_dir, shards, stage, iters, batch, aux_size=64,
            checkpoint=None, explicit_vad=False, vad_weight=1.0):
    common = {
        'trainer': {
            'factory': 'tssep_tpu_torch.train.trainer.Trainer',
            'model': {
                'factory': 'tssep_tpu_torch.tasks.model.Model',
                'fe': {'factory':
                       'tssep_tpu_torch.features.extractor.'
                       'Log1pMaxNormAbsSTFT',
                       'size': 1024, 'shift': 256, 'window': 'hann'},
                'reader': {
                    'factory':
                        'tssep_tpu_torch.data.shard_corpus.ShardCorpusReader',
                    'train_shard': str(shards['train']),
                    'validate_shard': str(shards['validate']),
                    'eval_shard': str(shards['eval']),
                    'aux_size': aux_size,
                },
                'mask_estimator': {
                    'factory': 'tssep_tpu_torch.nn.estimator.MaskEstimator',
                    'units': 64, 'projs': 64, 'combination': 'mul',
                    'ts_vad': 8, 'aux_net_output_size': aux_size,
                    'num_averaged_permutations': 2,
                    'output_resolution': 't' if stage == 'tsvad' else 'tf',
                },
            },
            'summary_trigger': [max(iters // 10, 1), 'iteration'],
            'checkpoint_trigger': [max(iters // 10, 1), 'iteration'],
            'stop_trigger': [iters, 'iteration'],
            # validation-loss early stopping: the best checkpoint is what
            # gets evaluated, so once validation stops improving more
            # training only overfits (round-3 rehearsal failure mode).
            'early_stop_patience': 4,
            'storage_dir': str(Path(work_dir) / stage),
        },
        'train_batchsize': batch,
        'validation_batchsize': batch,
        'cache_datasets_on_device': True,
    }
    if stage == 'tsvad':
        common['trainer']['model']['loss'] = {
            'factory': 'tssep_tpu_torch.tasks.losses.VADSigmoidBCE',
            'target': 'Vad'}
    else:
        if explicit_vad:
            # The reference's joint head (net.py explicit_vad + loss.py
            # SignalAndVADSigmoidBCE): channel 0 of the head is a TRAINED
            # per-frame activity gate multiplied onto the mask.  Standalone
            # TS-SEP then diarizes from a BCE-trained gate instead of
            # mask statistics (the mask-derived activity tracks words, not
            # turns — TPU_R5F/I sweeps).
            common['trainer']['model']['mask_estimator']['explicit_vad'] \
                = True
            common['trainer']['model']['loss'] = {
                'factory':
                    'tssep_tpu_torch.tasks.losses.SignalAndVADSigmoidBCE',
                'target': 'Vad',
                'vad_weight': float(vad_weight),
                'signal_loss': {
                    'factory': 'tssep_tpu_torch.tasks.losses.LogMAE',
                    'target': 'speaker_reverberation_early_ch0'}}
        else:
            common['trainer']['model']['loss'] = {
                'factory': 'tssep_tpu_torch.tasks.losses.LogMAE',
                'target': 'speaker_reverberation_early_ch0'}
        common['init_ckpt'] = {
            'factory': 'tssep_tpu_torch.train.init_ckpt.InitCheckPointVAD2Sep',
            'init_ckpt': str(checkpoint)}
    return common


def _dump_stage_config(storage_dir, full_cfg):
    """Write the stage's complete factory config to
    ``<storage_dir>/config.yaml`` (the reference dumps a re-runnable
    ``config.yaml`` into every storage dir, ``run.py:138-152``); the eval
    CLI rebuilds the experiment from it."""
    from tssep_tpu_torch.train.run import dump_config
    storage_dir = Path(storage_dir)
    storage_dir.mkdir(parents=True, exist_ok=True)
    dump_config(storage_dir, {'eg': full_cfg})


def main(work_dir='egs/simulated', train_examples=None, eval_examples=4,
         tsvad_iters=1600, tssep_iters=800, batch=8, aux_size=513,
         duration=5.0, num_channels=1, reverb_taps=0, speaker_pool=16,
         strict_comparison=True, vocabulary=0, ctc_steps=900,
         explicit_vad=1, vad_weight=0.3, *, device='cuda'):
    """``speaker_pool`` defaults to a CLOSED set of 16 voices shared by the
    train/validate/eval splits — the reference's enrolled-speaker condition
    (LibriCSS evaluates known, enrolled speakers).  The round-3 rehearsal
    trained open-set on 32 fixed meetings and memorized the training voices
    (train BCE 0.002 vs validation 1.407); see RESULTS.md.

    ``train_examples=None`` scales the corpus with the optimizer budget so
    each meeting is seen at most ~25 times.

    ``explicit_vad=1, vad_weight=0.3`` (the default since TPU_R5T): the
    TS-SEP stage trains the reference's joint head — channel 0 is a
    BCE-trained activity gate (``SignalAndVADSigmoidBCE``), so ONE model
    both diarizes and separates. ``--explicit_vad=0`` restores the
    LogMAE-only stage-2 (TPU_R5N).

    ``device``: the card (default; raises without CUDA) or ``'cpu'``."""
    # Numerics: the recipe's stages store in bfloat16 (the JAX recipe's
    # default, ``TSSEP_COMPUTE_DTYPE=bfloat16``: the clustered bf16
    # kernels) with the bf16 head (``TSSEP_HEAD_BF16=1``,
    # ``tssep_tpu/exp/run_simulated.py:139``); a caller's variables win.
    from tssep_tpu_torch.config.configurable import from_config
    from tssep_tpu_torch.data.simulate import MeetingSimulator, simulate_corpus
    from tssep_tpu_torch.eval.run import evaluate
    from tssep_tpu_torch.train.experiment import Experiment
    from tssep_tpu_torch.train.run import runtime_options

    environ = dict(os.environ)
    environ.setdefault('TSSEP_COMPUTE_DTYPE', 'bfloat16')
    environ.setdefault('TSSEP_HEAD_BF16', '1')
    device = torch.device(device)
    options = runtime_options(['--cpu'] if device.type == 'cpu' else [],
                              environ)

    work_dir = Path(work_dir)
    work_dir.mkdir(parents=True, exist_ok=True)

    total_seen = max(tsvad_iters, tssep_iters) * batch
    if train_examples is None:
        train_examples = int(np.clip(total_seen // 25, 32, 2048))
    epochs = total_seen / train_examples
    if epochs > 50:
        print(f'WARNING: {total_seen} training examples will be drawn from '
              f'a corpus of only {train_examples} meetings '
              f'({epochs:.0f} epochs) — expect memorization. Raise '
              f'train_examples or lower the iteration count.',
              file=sys.stderr)

    # 1. simulate corpora (eval meetings are twice as long -> exercises the
    #    chunked long-recording path)
    shards = {}
    for split, n, seed, dur in (('train', train_examples, 0, duration),
                                ('validate', max(eval_examples, 2), 1,
                                 duration),
                                ('eval', eval_examples, 2, duration * 2)):
        path = work_dir / f'{split}.shard'
        if not path.exists():
            print(f'Simulating {n} {split} meetings -> {path}')
            simulate_corpus(path, n, MeetingSimulator(
                duration=dur, aux_size=aux_size, seed=seed,
                embedding_kind='gate', num_channels=num_channels,
                reverb_taps=reverb_taps, speaker_pool=speaker_pool,
                vocabulary=vocabulary))
        shards[split] = path

    # With a word vocabulary the corpus is ASR-scorable: train the
    # in-framework CTC recognizer on the same (closed-pool) voice
    # distribution; evaluate() then also reports cpWER per recording.
    transcriber = None
    if vocabulary:
        from tssep_tpu_torch.eval.ctc import CTCRecognizer
        asr_path = work_dir / 'ctc_asr.npz'
        asr_sim = MeetingSimulator(
            duration=duration, aux_size=aux_size, seed=3,
            embedding_kind='gate', speaker_pool=speaker_pool,
            vocabulary=vocabulary, reverb_taps=reverb_taps)
        if asr_path.exists():
            transcriber = CTCRecognizer(vocabulary=vocabulary,
                                        device=device).load(asr_path)
            print(f'Loaded CTC recognizer from {asr_path}')
        else:
            print(f'Training CTC recognizer ({ctc_steps} steps)')
            transcriber = CTCRecognizer.train_on(
                asr_sim, steps=ctc_steps, verbose=True, device=device)
            transcriber.save(asr_path)

    # 2. stage 1: TS-VAD
    print('=== Stage 1: TS-VAD')
    cfg = _config(work_dir, shards, 'tsvad', tsvad_iters, batch, aux_size)
    full_cfg = Experiment.get_config(cfg)
    _dump_stage_config(work_dir / 'tsvad', full_cfg)
    eg = from_config(full_cfg, **options)
    eg.train()
    tsvad_ckpt = eg.trainer.checkpoint_dir / 'ckpt_best_loss.npz'
    # The 8-speaker conditioning task has a long loss plateau (~0.52 BCE =
    # activity base rate) whose escape iteration varies with the RNG
    # stream (observed 480-560 in TPU_R5C; past 800 in TPU_R5K — which is
    # why tsvad_iters defaults to 1600 now).  A TS-VAD stuck on the
    # plateau detects no speech, silently poisoning every downstream eval
    # — fail HERE, not 20 minutes later in a degenerate comparison.
    best = getattr(eg.trainer, 'best_validation_loss', None)
    if best is not None and best > 0.35:
        msg = (f'TS-VAD never escaped the conditioning plateau (best '
               f'validation BCE {best:.3f} > 0.35 after {tsvad_iters} '
               f'iterations); raise tsvad_iters or change the trainer '
               f'seed. Downstream separation/eval would be meaningless.')
        # Tiny smoke runs (CI / plumbing tests) are not expected to learn;
        # only a realistic iteration budget makes the plateau an error.
        if strict_comparison and tsvad_iters >= 400:
            raise RuntimeError(msg)
        print(f'WARNING: {msg}', file=sys.stderr)

    # 3. stage 2: TS-SEP, warm-started (activity head broadcast over freq)
    print('=== Stage 2: TS-SEP (warm start)')
    cfg = _config(work_dir, shards, 'tssep', tssep_iters, batch, aux_size,
                  checkpoint=tsvad_ckpt, explicit_vad=bool(explicit_vad),
                  vad_weight=vad_weight)
    full_cfg = Experiment.get_config(cfg)
    _dump_stage_config(work_dir / 'tssep', full_cfg)
    eg2 = from_config(full_cfg, **options)
    eg2.train()

    # 4. score both stages on the (longer) eval meetings.  Word corpora
    # pause ~(word_gap + trailing off slots) between words while the
    # reference activity is turn-level -> bridge sub-0.45 s silences when
    # diarizing (standard post-processing; tuned to the simulator's gap).
    overrides = None
    if vocabulary:
        sim0 = MeetingSimulator(duration=duration, aux_size=aux_size,
                                vocabulary=vocabulary)
        gap_sec = sim0.word_gap_sec + 2 * sim0.word_sec / 6 + 0.1
        fe = eg2.trainer.model.fe
        frames = int(gap_sec * 16000 / fe.shift) + 1
        overrides = {'merge_gap_frames': frames}
    print('=== Eval: TS-VAD (diarization)')
    vad_metrics = evaluate(eg, beamform=False, driver_overrides=overrides)
    print('=== Eval: TS-SEP (separation, masking)')
    # Standalone TS-SEP diarizes from its own masks.  Signal-level masks
    # track words, not turns: bridge in-turn gaps (merge_gap above), score
    # activity with a high frequency quantile (active speech is
    # frequency-sparse; the freq mean of an active frame sits near the
    # silence floor), and dilate onsets/offsets the reference VAD includes
    # but the signal energy does not.
    sep_overrides = dict(overrides or {})
    if not explicit_vad:
        # Mask-derived activity tracks words/signal energy, not turns:
        # high freq-quantile statistic + onset/offset dilation + a wider
        # gap bridge (2x: soft word onsets/decays gap too).  Sweep winner
        # TPU_R5F/R5I.  With explicit_vad the activity is a BCE-TRAINED
        # turn-level gate — none of this is needed.
        sep_overrides.setdefault('activity_stat', 'q98')
        sep_overrides.setdefault('pad_frames', 8)
        if overrides:
            sep_overrides['merge_gap_frames'] = \
                2 * overrides['merge_gap_frames']
    sep_metrics = evaluate(eg2, beamform=False, transcriber=transcriber,
                           driver_overrides=sep_overrides)
    if num_channels >= 6:
        # Multichannel rehearsal: the full ClassicBF MVDR path (per-VAD-
        # segment PSDs + Souden beamforming, reference enhancer.py:451-548)
        # against plain masking — in the CANONICAL JOINT deployment:
        # diarization from the TS-VAD stage (trained on activity) and masks
        # from the TS-SEP stage.  Mask-derived activity diarizes far worse
        # on the word corpus and its misses dominate every downstream
        # metric.
        joint = {'dia_eg': eg, 'driver_overrides': overrides,
                 'transcriber': transcriber}
        print('=== Eval: joint (TS-VAD dia + TS-SEP masks), masking')
        sep_metrics = evaluate(
            eg2, beamform=False,
            out=Path(eg2.trainer.storage_dir) / 'eval_joint', **joint)
        print('=== Eval: joint (TS-VAD dia + TS-SEP masks), MVDR')
        bf_metrics = evaluate(
            eg2, beamform=True,
            out=Path(eg2.trainer.storage_dir) / 'eval_joint_bf', **joint)
        # MVDR + mask post-filter (reference enhancer.py:542-545: the
        # distortionless beamformer keeps noise/leakage in speech gaps;
        # flooring the target mask on top restores the gap structure).
        from tssep_tpu_torch.eval.classic_bf import ClassicBF
        joint_pm = dict(joint)
        joint_pm['driver_overrides'] = dict(overrides or {})
        joint_pm['driver_overrides']['enhancer'] = ClassicBF(
            masking=True, masking_eps=0.3)
        print('=== Eval: joint, MVDR + mask postfilter (eps 0.3)')
        bfpm_metrics = evaluate(
            eg2, beamform=True,
            out=Path(eg2.trainer.storage_dir) / 'eval_joint_bfpm',
            **joint_pm)
        # A "comparison" in which the beamformer never ran is not a
        # comparison (round-3 failure mode: DER 1.0 -> zero diarized
        # segments -> both paths emitted byte-identical silence).  The
        # reference asserts loudly on its eval preconditions
        # (enhancer.py:462-467); so do we.
        no_segments = [r['example_id']
                       for r in bf_metrics['per_recording']
                       if r.get('num_segments', 0) < 1]
        invalid = None
        if no_segments:
            invalid = (
                f'MVDR-vs-masking comparison is invalid: the beamformer '
                f'never beamformed a single segment on recordings '
                f'{no_segments} (no diarized activity). The upstream '
                f'model failed; fix it before claiming a comparison.')
        elif (bf_metrics['summary'].get('degenerate')
                or sep_metrics['summary'].get('degenerate')):
            invalid = (
                'MVDR-vs-masking comparison is invalid: a degenerate eval '
                f"(bf: {bf_metrics['summary'].get('degenerate_reasons')}, "
                f"masking: "
                f"{sep_metrics['summary'].get('degenerate_reasons')})")
        if invalid:
            if strict_comparison:
                raise RuntimeError(invalid)
            print(f'WARNING: {invalid}', file=sys.stderr)
        cmp = {
            'masking_si_sdr': sep_metrics['summary'].get('mean_si_sdr'),
            'mvdr_si_sdr': bf_metrics['summary'].get('mean_si_sdr'),
            'mvdr_pm_si_sdr': bfpm_metrics['summary'].get('mean_si_sdr'),
        }
        if transcriber is not None:
            cmp['masking_cp_wer'] = sep_metrics['summary'].get('mean_cp_wer')
            cmp['mvdr_cp_wer'] = bf_metrics['summary'].get('mean_cp_wer')
            cmp['mvdr_pm_cp_wer'] = bfpm_metrics['summary'].get(
                'mean_cp_wer')
        print('=== Masking vs MVDR:', cmp)
        return vad_metrics, sep_metrics, bf_metrics
    return vad_metrics, sep_metrics


def main_multichannel(work_dir='egs/simulated_mc', **kwargs):
    """The >=6-mic, reverberant rehearsal: trains on 6-channel simulated
    meetings and scores masking vs ClassicBF MVDR beamforming."""
    kwargs.setdefault('num_channels', 6)
    kwargs.setdefault('reverb_taps', 2)
    return main(work_dir, **kwargs)


def joint_eval(vad_eg, sep_eg, limit=None):
    """The canonical TS-SEP deployment: diarization from the TS-VAD model,
    separation masks from the TS-SEP model (reference workflow: the VAD
    stage's activity drives the segment loop; the SEP stage's masks drive
    reconstruction). The STFT runs on the models' device; masking, the
    ISTFT and scoring on the host in float64."""
    import json

    from tssep_tpu_torch.eval.driver import (ChunkedMaskEstimator,
                                             calibrate_threshold,
                                             diarize_from_activity, to_numpy)
    from tssep_tpu_torch.eval.metrics import der as der_fn
    from tssep_tpu_torch.eval.metrics import si_sdr
    from tssep_tpu_torch.signal.vad import stft_vad

    for eg in (vad_eg, sep_eg):
        eg.trainer.ensure_init()
        ck = eg.trainer.checkpoint_dir / 'ckpt_best_loss.npz'
        if ck.exists():
            eg.trainer.load(ck)
    vad_model, sep_model = vad_eg.trainer.model, sep_eg.trainer.model
    vad_chunked = ChunkedMaskEstimator(vad_model)
    sep_chunked = ChunkedMaskEstimator(sep_model)

    def stft(model, signal):
        return model.fe.stft(torch.as_tensor(
            np.asarray(signal), dtype=torch.float32, device=model.device))

    # calibrate the VAD threshold on validation
    cal = vad_model.prepare_validate_dataset(device=False, prefetch=False)
    acts, refs = [], []
    for i, ex in enumerate(cal):
        if i >= 4:
            break
        obs_stft = stft(vad_model, ex['observation'])
        _, activity = vad_chunked(obs_stft, np.asarray(ex['auxInput']))
        refs.append(np.asarray(stft_vad(np.asarray(ex['vad']),
                                        vad_model.fe.window_length,
                                        vad_model.fe.shift,
                                        vad_model.fe.fading), dtype=bool))
        acts.append(activity)
    th, cal_der = calibrate_threshold(acts, refs)
    print(f'joint eval: VAD threshold {th:.2f} (calibration DER {cal_der:.3f})')

    ds = sep_model.prepare_eval_dataset(device=False, prefetch=False)
    results = []
    for i, ex in enumerate(ds):
        if limit is not None and i >= limit:
            break
        obs = np.asarray(ex['observation'])
        aux = np.asarray(ex['auxInput'])
        obs_stft = stft(sep_model, obs)
        _, activity = vad_chunked(obs_stft, aux)
        dia = diarize_from_activity(activity, th)
        masks, _ = sep_chunked(obs_stft, aux)
        est_stft = (to_numpy(obs_stft[0]).astype(np.complex128)[None]
                    * np.squeeze(masks, axis=-3)
                    * np.stack([np.asarray(ai, dtype=np.float64)
                                for ai in dia])[..., None])
        est = sep_model.fe.istft(torch.as_tensor(est_stft),
                                 num_samples=obs.shape[-1]).numpy()
        rec = {}
        if 'vad' in ex:
            ref = np.asarray(stft_vad(np.asarray(ex['vad']),
                                      vad_model.fe.window_length,
                                      vad_model.fe.shift,
                                      vad_model.fe.fading), dtype=bool)
            hyp = np.stack([np.asarray(ai, dtype=bool) for ai in dia])
            frames = min(ref.shape[-1], hyp.shape[-1])
            rec['der'] = der_fn(ref[..., :frames], hyp[..., :frames])['der']
        tgt = ex.get('speaker_reverberation_early_ch0')
        if tgt is not None:
            tgt = np.asarray(tgt)
            active = np.abs(tgt).sum(-1) > 0
            if active.any():
                rec['si_sdr'] = float(np.mean(si_sdr(
                    tgt[active], est[active][..., :tgt.shape[-1]])))
                mix = np.broadcast_to(obs[0], tgt.shape)
                rec['si_sdr_mixture'] = float(np.mean(si_sdr(
                    tgt[active], mix[active])))
        results.append(rec)
        print(rec)
    # si_sdr returns -inf for silent/degenerate estimates; averaging a
    # -inf into the summary would poison it (and emit non-standard JSON).
    # Mirror eval/run.py: mean over finite values, flag the rest loudly.
    summary, degenerate = {}, 0
    for k in ('der', 'si_sdr', 'si_sdr_mixture'):
        vals = [r[k] for r in results if k in r]
        finite = [v for v in vals if np.isfinite(v)]
        degenerate += len(vals) - len(finite)
        if finite:
            summary[k] = float(np.mean(finite))
    if degenerate:
        summary['degenerate'] = degenerate
        print(f'WARNING: {degenerate} non-finite metric values excluded '
              f'from the joint summary (degenerate separation output)')
    print('JOINT SUMMARY', json.dumps(summary))
    return summary


def _cli(argv):
    """(positional arguments, keyword arguments) of the command line:
    ``--key=value`` as main()'s keywords (ints, then floats, else strings),
    ``--cpu`` as ``device='cpu'``, ``--multichannel`` as ``multichannel``."""
    args = [a for a in argv if not a.startswith('-')]
    kw = {}
    for a in argv:
        # --key=value overrides for main()'s keyword arguments
        # (e.g. --vocabulary=8 --ctc_steps=1600 --tsvad_iters=400)
        if a.startswith('--') and '=' in a:
            k, _, v = a[2:].partition('=')
            for coerce in (int, float):
                try:
                    v = coerce(v)
                    break
                except ValueError:
                    pass
            kw[k] = v
    if '--cpu' in argv:
        kw['device'] = 'cpu'
    return args, kw, '--multichannel' in argv


if __name__ == '__main__':
    _args, _kw, _multichannel = _cli(sys.argv[1:])
    (main_multichannel if _multichannel else main)(*_args[:1], **_kw)
