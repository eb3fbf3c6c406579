"""Evaluation CLI: port of ``tssep_tpu/eval/run.py``. Scores a trained
experiment on its eval dataset::

    python -m tssep_tpu_torch.eval.run with <storage_dir>/config.yaml \
        [checkpoint=...] [out=...] [beamform=true|false] \
        [transcriber=pkg.module.MyASR] [limit=N] [driver.<field>=...] \
        [--strict] [--cpu] [--pdb]

Loads the experiment config (one the port's CLI wrote, or one the JAX
package's wrote: its factories are read as the port's) and its checkpoint
(best by default), runs the long-recording eval driver over the eval
dataset on the card (``--cpu``: on the CPU; without CUDA and without it,
the CLI raises) — chunked inference, diarization, beamforming/masking,
stitching — and writes per-speaker WAVs and a ``metrics.json`` with
per-recording and mean DER / SI-SDR (and cpWER with a transcriber), the
threshold calibration and the WAV writer that ran. Storage type and kernel
switches follow the environment as in ``tssep_tpu_torch.train.run``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from tssep_tpu_torch.config.configurable import from_config
from tssep_tpu_torch.eval.driver import (
    EvalDriver, calibrate_threshold, save_wavs, wav_writer)
from tssep_tpu_torch.eval.metrics import si_sdr
from tssep_tpu_torch.signal.vad import stft_vad
from tssep_tpu_torch.train.run import (
    build_config, parse_argv, run_with_pdb, runtime_options)

__all__ = ['evaluate', 'main', 'DegenerateEvalError', 'degenerate_problems']

#: Calibration / eval DER at or above this is "the model detects (almost)
#: nothing / everything" — a failed model, not a result.
DEGENERATE_DER = 0.9


class DegenerateEvalError(RuntimeError):
    """Raised under ``strict=True`` when the evaluation is degenerate
    (calibration DER >= 0.9, eval DER >= 0.9, or every recording's
    separation estimate is silence)."""


def degenerate_problems(calibration, summary, records):
    """Summary-level degenerate verdict: each failure mode contributes a
    reason string. Empty list = the eval looks like a real measurement."""
    problems = []
    if calibration and calibration.get('degenerate'):
        problems.append(f"calibration DER {calibration['der']:.3f} >= "
                        f"{DEGENERATE_DER}")
    if summary.get('mean_der', 0) >= DEGENERATE_DER:
        problems.append(f"mean eval DER {summary['mean_der']:.3f} >= "
                        f"{DEGENERATE_DER}")
    n_degenerate = sum(1 for r in records if r.get('degenerate'))
    if records and n_degenerate == len(records):
        problems.append('every recording produced silent separation '
                        'estimates')
    return problems


def _best_checkpoint(trainer):
    for name in ('ckpt_best_loss.npz', 'ckpt_latest.npz'):
        cand = trainer.checkpoint_dir / name
        if cand.exists():
            return cand
    return None


def evaluate(eg, checkpoint=None, out=None, beamform=None, limit=None,
             transcriber=None, strict=False, driver_overrides=None,
             dia_eg=None):
    """Run the eval driver for an Experiment; returns the metrics dict.

    ``transcriber``: optional ASR hook ``(samples, sample_rate) -> str``;
    recordings whose example dict carries per-speaker reference
    ``transcription`` are then also scored with cpWER
    (``EvalDriver.score_wer``).

    ``strict``: raise :class:`DegenerateEvalError` instead of returning
    when the eval is degenerate (see the ``degenerate`` summary flag)."""
    trainer = eg.trainer
    trainer.ensure_init()
    storage_dir = Path(trainer.storage_dir)
    if checkpoint is None:
        checkpoint = _best_checkpoint(trainer)
    if checkpoint is not None:
        trainer.load(checkpoint)
        print(f'Loaded checkpoint {checkpoint} (iteration '
              f'{trainer.iteration})')
    else:
        print('WARNING: no checkpoint found; evaluating the initialization')

    out_dir = Path(out) if out else storage_dir / 'eval' / str(trainer.iteration)
    out_dir.mkdir(parents=True, exist_ok=True)

    model = trainer.model
    # driver_overrides: EvalDriver field overrides (e.g. merge_gap_frames
    # for corpora whose reference activity is turn-level while the speech
    # pauses within turns, or activity_stat='q90').
    overrides = dict(driver_overrides or {})
    if dia_eg is not None:
        # Canonical joint deployment: diarization from the (TS-VAD)
        # stage trained on activity; masks from this experiment's model.
        dia_trainer = dia_eg.trainer
        dia_trainer.ensure_init()
        # An untrained (randomly initialized) diarizer would silently
        # degrade every downstream metric, so no checkpoint at all is an
        # error under ``strict`` and a loud warning otherwise.
        dia_ckpt = _best_checkpoint(dia_trainer)
        if dia_ckpt is not None:
            dia_trainer.load(dia_ckpt)
            print(f'Diarization from {dia_ckpt} '
                  f'(iteration {dia_trainer.iteration})')
        else:
            msg = (f'no diarization checkpoint under '
                   f'{dia_trainer.checkpoint_dir} — dia_eg would run with '
                   f'random init')
            if strict:
                raise DegenerateEvalError(msg)
            print(f'WARNING: {msg}')
        overrides.update(dia_model=dia_trainer.model)
    driver = EvalDriver(model, **overrides)

    # Diarization threshold calibration on the validation set (when it has
    # reference activity) — reference workflow's 'domain adaptation' step.
    calibration = None
    try:
        cal_ds = model.prepare_validate_dataset(device=False, prefetch=False)
        acts, refs = [], []
        for i, ex in enumerate(cal_ds):
            if i >= 4 or 'vad' not in ex:
                break
            obs_stft = driver.stft(np.asarray(ex['observation']))
            activity = driver.activity(obs_stft, np.asarray(ex['auxInput']))
            ref = np.asarray(stft_vad(np.asarray(ex['vad']),
                                      model.fe.window_length, model.fe.shift,
                                      model.fe.fading), dtype=bool)
            acts.append(activity)
            refs.append(ref)
        if acts:
            th, cal_der = calibrate_threshold(
                acts, refs, smooth_kernel=driver.smooth_kernel,
                min_frames=driver.min_frames,
                merge_gap=driver.merge_gap_frames,
                pad_frames=driver.pad_frames)
            print(f'Calibrated VAD threshold: {th:.2f} '
                  f'(calibration DER {cal_der:.3f})')
            driver.vad_threshold = th
            calibration = {'threshold': float(th), 'der': float(cal_der)}
            if cal_der >= DEGENERATE_DER:
                # "Best threshold still misses/hallucinates ~everything" is
                # a failed model; it must not pass as a calibrated eval.
                calibration['degenerate'] = True
                print(f'WARNING: threshold calibration is DEGENERATE: the '
                      f'best achievable calibration DER is {cal_der:.3f} '
                      f'(>= {DEGENERATE_DER}). The model detects (almost) '
                      f'no speech at any threshold; downstream separation '
                      f'metrics are meaningless.', file=sys.stderr)
    except Exception as e:  # noqa: BLE001 - calibration is best-effort,
        # but its failure must be LOUD: recorded in metrics.json (below)
        # and on stderr, not just lost in stdout.
        calibration = {'error': f'{type(e).__name__}: {e}',
                       'threshold': driver.vad_threshold}
        print(f'WARNING: threshold calibration failed, using default '
              f'threshold {driver.vad_threshold}: {e}', file=sys.stderr)

    ds = model.prepare_eval_dataset(device=False, prefetch=False)

    sample_rate = getattr(model.reader, 'sample_rate', 16000)
    writer_name, _ = wav_writer()
    records = []
    for i, ex in enumerate(ds):
        if limit is not None and i >= limit:
            break
        example_id = ex.get('example_id', f'ex{i}')
        if isinstance(example_id, list):
            example_id = example_id[0]
        obs = np.asarray(ex['observation'])
        aux = np.asarray(ex['auxInput'])
        result = driver.run_recording(obs, aux, beamform=beamform)
        record = {'example_id': str(example_id),
                  'num_segments': int(result['num_segments'])}
        if 'vad' in ex:
            record.update(driver.score_der(result, np.asarray(ex['vad'])))
        if transcriber is not None and 'transcription' in ex:
            record.update(driver.score_wer(
                result, ex['transcription'], transcriber,
                sample_rate=sample_rate))
        target_key = 'speaker_reverberation_early_ch0'
        if target_key in ex:
            tgt = np.asarray(ex[target_key])
            est = np.asarray(result['time_estimate'])[..., :tgt.shape[-1]]
            active = np.abs(tgt).sum(-1) > 0
            if active.any():
                vals = np.atleast_1d(si_sdr(tgt[active], est[active]))
                finite = np.isfinite(vals)
                if finite.any():
                    record['si_sdr'] = float(np.mean(vals[finite]))
                if not finite.all():
                    # -inf = silent estimate (eval.metrics.si_sdr); a
                    # totally failed separation must be loud, not a "0 dB".
                    record['degenerate'] = True
                    record['num_silent_speakers'] = int((~finite).sum())
                    print(f'WARNING: {example_id}: '
                          f'{int((~finite).sum())}/{len(vals)} separated '
                          f'streams are silence (degenerate separation)',
                          file=sys.stderr)
        save_wavs(result, out_dir / 'audio', sample_rate=sample_rate,
                  example_id=str(example_id))
        record['stage_ms'] = result['stage_ms']
        records.append(record)
        print(json.dumps(record))

    summary = {'num_recordings': len(records)}
    for key in ('der', 'si_sdr', 'cp_wer', 'orc_wer'):
        vals = [r[key] for r in records if key in r]
        if vals:
            summary[f'mean_{key}'] = float(np.mean(vals))
    n_degenerate = sum(1 for r in records if r.get('degenerate'))
    if n_degenerate:
        summary['num_degenerate_recordings'] = n_degenerate
    problems = degenerate_problems(calibration, summary, records)
    if problems:
        summary['degenerate'] = True
        summary['degenerate_reasons'] = problems
        print('WARNING: eval is DEGENERATE: ' + '; '.join(problems),
              file=sys.stderr)
    metrics = {'summary': summary, 'per_recording': records,
               'checkpoint': str(checkpoint), 'iteration': trainer.iteration,
               'calibration': calibration, 'wav_writer': writer_name}
    (out_dir / 'metrics.json').write_text(json.dumps(metrics, indent=1))
    print('SUMMARY', json.dumps(summary))
    if strict and problems:
        raise DegenerateEvalError('; '.join(problems))
    return metrics


def _transcriber(path):
    """A dotted path to a Transcriber instance, class, or factory: a class
    or a zero-required-arg factory is called to build the transcriber;
    anything else (incl. a ``(samples, sr)`` callable) is used directly."""
    import importlib
    import inspect
    from tssep_tpu_torch.eval.wer import Transcriber
    mod, _, attr = path.rpartition('.')
    obj = getattr(importlib.import_module(mod), attr)
    if isinstance(obj, type):
        return obj()
    if callable(obj) and not isinstance(obj, Transcriber):
        try:
            n_required = sum(
                1 for p in inspect.signature(obj).parameters.values()
                if p.default is inspect.Parameter.empty
                and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))
        except (TypeError, ValueError):
            n_required = 2
        return obj() if n_required == 0 else obj
    return obj


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    use_pdb = '--pdb' in argv
    strict = '--strict' in argv
    argv = [a for a in argv if a != '--strict']

    def dispatch():
        _, files, overrides = parse_argv(argv)
        checkpoint = overrides.pop('checkpoint', None)
        out = overrides.pop('out', None)
        beamform = overrides.pop('beamform', None)
        limit = overrides.pop('limit', None)
        strict_ = overrides.pop('strict', strict)
        if isinstance(strict_, str):
            strict_ = strict_.lower() in ('1', 'true', 'yes')
        transcriber = overrides.pop('transcriber', None)
        if isinstance(transcriber, str):
            transcriber = _transcriber(transcriber)
        # ``driver.<field>=value`` CLI overrides map onto EvalDriver fields
        # (e.g. driver.activity_stat=q98 driver.pad_frames=8
        # driver.merge_gap_frames=58 driver.vad_threshold=0.3).
        driver_overrides = {}
        for k in list(overrides):
            if k.startswith('driver.'):
                driver_overrides[k[len('driver.'):]] = overrides.pop(k)
        options = runtime_options(argv)
        config = build_config(files, overrides)
        eg = from_config(config['eg'], **options)
        return evaluate(eg, checkpoint=checkpoint, out=out,
                        beamform=beamform, limit=limit,
                        transcriber=transcriber, strict=strict_,
                        driver_overrides=driver_overrides or None)

    return run_with_pdb(dispatch, use_pdb)


if __name__ == '__main__':
    main()
