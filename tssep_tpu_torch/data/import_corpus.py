"""Import a real on-disk WAV corpus into the native shard store: port of
``tssep_tpu/data/import_corpus.py`` (a numpy copy on the port's native
runtime, ``runtime/native.py``).

The reference consumes externally prepared examples (its companion repo
``tssep_data`` does data prep; in-repo contract: ``Model.prepare_eval_dataset``
reference ``model.py:429-452`` and the reader protocol of ``data.py:58-146``).
This module is the in-framework preparation step: a directory of recording
WAVs plus per-speaker segment annotations (RTTM or a JSON manifest) becomes
one shard file that ``ShardCorpusReader`` serves with the full reader
contract — ``observation`` (C, T), sample-domain ``vad`` (S, T), ``auxInput``
(S, A) enrollment embeddings, and per-speaker ``transcription`` for cpWER
scoring.

Inputs
------
- ``wav_dir``: ``<recording_id>.wav`` per recording (mono or multi-channel).
- Annotations: an RTTM file (``SPEAKER <rec> <ch> <tbeg> <tdur> <NA> <NA>
  <spk> ...``) or a JSON manifest ``{rec: {spk: [[tbeg, tend], ...]}}`` in
  seconds.
- ``enrollment``: ``'auto'`` (cut each speaker's least-overlapped active
  audio from the recording itself), or a directory of ``<spk>.wav``
  enrollment recordings.
- ``transcripts`` (optional): JSON ``{rec: {spk: "text" | ["utt", ...]}}``.

CLI::

    python -m tssep_tpu_torch.data.import_corpus --wav-dir wavs/ \
        --rttm all.rttm --out corpus.shard --aux-size 513 \
        [--transcripts trans.json] [--enrollment enroll/] [--slots 8]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

__all__ = ['parse_rttm', 'load_audio', 'cut_enrollment', 'import_corpus']


def parse_rttm(path):
    """RTTM -> ``{recording_id: {speaker_id: [(tbeg, tend), ...]}}``.

    Only ``SPEAKER`` lines are used; times in seconds.
    """
    out = {}
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if not parts or parts[0].upper() != 'SPEAKER':
            continue
        rec, tbeg, tdur, spk = parts[1], float(parts[3]), float(parts[4]), \
            parts[7]
        out.setdefault(rec, {}).setdefault(spk, []).append(
            (tbeg, tbeg + tdur))
    for rec in out.values():
        for segs in rec.values():
            segs.sort()
    return out


def load_audio(path):
    """WAV -> ((channels, samples) float32, sample_rate).

    Native codec when built; scipy fallback otherwise.
    """
    from tssep_tpu_torch.runtime import native
    try:
        if native.available():
            data, sr = native.wav_read(path, channels_first=True)
            return np.atleast_2d(np.asarray(data, np.float32)), int(sr)
    except Exception:  # noqa: BLE001 - fall through to scipy
        pass
    import scipy.io.wavfile
    sr, data = scipy.io.wavfile.read(str(path))
    data = np.asarray(data)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[None]
    else:
        data = data.T                                    # (C, T)
    return np.ascontiguousarray(data), int(sr)


def _sample_vad(segments, num_samples, sample_rate):
    """[(tbeg, tend), ...] seconds -> (num_samples,) bool."""
    vad = np.zeros(num_samples, dtype=bool)
    for tbeg, tend in segments:
        b = max(0, int(round(tbeg * sample_rate)))
        e = min(num_samples, int(round(tend * sample_rate)))
        if e > b:
            vad[b:e] = True
    return vad


def cut_enrollment(observation_ch0, vad, other_vad, sample_rate,
                   max_seconds=30.0):
    """Cut enrollment audio for one speaker from the recording itself:
    prefer samples where the speaker is active and nobody else is
    (non-overlapped speech is the cleanest enrollment available without
    external data)."""
    clean = vad & ~other_vad
    pick = clean if clean.any() else vad
    samples = observation_ch0[pick]
    limit = int(max_seconds * sample_rate)
    return samples[:limit]


def import_corpus(out_shard, wav_dir, annotations, *, aux_size=513,
                  embedding_kind='gate', enrollment='auto',
                  transcripts=None, num_speaker_slots=None,
                  expected_sample_rate=None, max_enrollment_seconds=30.0,
                  verbose=True):
    """Build a native shard corpus from WAVs + segment annotations.

    ``annotations``: RTTM path, JSON-manifest path, or the parsed dict.
    ``num_speaker_slots``: fixed speaker count S of the model (e.g.
    ``ts_vad=8``); recordings with fewer speakers get silent slots with
    zero embeddings.  Defaults to the corpus-wide maximum.
    Returns the list of imported example ids.
    """
    from tssep_tpu_torch.data.simulate import SpeakerEmbedder
    from tssep_tpu_torch.runtime.native import ShardWriter

    if isinstance(annotations, (str, Path)):
        text = Path(annotations).read_text()
        if str(annotations).endswith('.json') or text.lstrip()[:1] == '{':
            raw = json.loads(text)
            annotations = {
                rec: {spk: [tuple(seg) for seg in segs]
                      for spk, segs in spks.items()}
                for rec, spks in raw.items()}
        else:
            annotations = parse_rttm(annotations)
    if isinstance(transcripts, (str, Path)):
        transcripts = json.loads(Path(transcripts).read_text())
    transcripts = transcripts or {}

    if num_speaker_slots is None:
        num_speaker_slots = max(len(spks) for spks in annotations.values())

    wav_dir = Path(wav_dir)
    embedder = None
    imported = []
    with ShardWriter(out_shard) as w:
        for rec in sorted(annotations):
            wav = wav_dir / f'{rec}.wav'
            if not wav.exists():
                raise FileNotFoundError(
                    f'annotated recording {rec!r} has no {wav}')
            obs, sr = load_audio(wav)
            if expected_sample_rate and sr != expected_sample_rate:
                raise ValueError(
                    f'{wav}: sample rate {sr} != expected '
                    f'{expected_sample_rate}')
            if embedder is None:
                embedder = SpeakerEmbedder(aux_size, sr,
                                           kind=embedding_kind)
            T = obs.shape[-1]
            speakers = sorted(annotations[rec])
            if len(speakers) > num_speaker_slots:
                raise ValueError(
                    f'{rec}: {len(speakers)} speakers > num_speaker_slots='
                    f'{num_speaker_slots}')
            vad = np.zeros((num_speaker_slots, T), dtype=bool)
            for i, spk in enumerate(speakers):
                vad[i] = _sample_vad(annotations[rec][spk], T, sr)

            aux = np.zeros((num_speaker_slots, aux_size), dtype=np.float32)
            for i, spk in enumerate(speakers):
                if enrollment == 'auto':
                    other = vad[:len(speakers)].sum(0) - vad[i] > 0
                    enroll = cut_enrollment(
                        obs[0], vad[i], other, sr,
                        max_seconds=max_enrollment_seconds)
                else:
                    epath = Path(enrollment) / f'{spk}.wav'
                    if not epath.exists():
                        raise FileNotFoundError(
                            f'no enrollment audio {epath} for {spk!r}')
                    e_audio, e_sr = load_audio(epath)
                    if e_sr != sr:
                        raise ValueError(
                            f'{epath}: enrollment sample rate {e_sr} != '
                            f'recording rate {sr}')
                    enroll = e_audio[0]
                if len(enroll) < 256:
                    raise ValueError(
                        f'{rec}/{spk}: only {len(enroll)} enrollment '
                        f'samples; need speech to embed')
                aux[i] = embedder(enroll)

            trans = []
            rec_trans = transcripts.get(rec, {})
            for i in range(num_speaker_slots):
                if i < len(speakers):
                    t = rec_trans.get(speakers[i], '')
                    if isinstance(t, (list, tuple)):
                        t = ' '.join(t)
                    trans.append(t)
                else:
                    trans.append('')

            payload = {
                'observation': obs.astype(np.float32),
                'vad': vad,
                'auxInput': aux,
                'speaker_ids': _encode_strings(
                    speakers + [''] * (num_speaker_slots - len(speakers))),
                'sample_rate': np.asarray(sr, dtype=np.int64),
            }
            if any(trans):
                payload['transcription'] = _encode_strings(trans)
            w.add_example(rec, payload)
            imported.append(rec)
            if verbose:
                dur = T / sr
                print(f'imported {rec}: {obs.shape[0]} ch, {dur:.1f}s, '
                      f'{len(speakers)} speakers'
                      + (', transcribed' if any(trans) else ''))
    return imported


def _encode_strings(strings):
    """list[str] -> uint8 array (JSON bytes; shard stores numerics only)."""
    return np.frombuffer(json.dumps(list(strings)).encode('utf-8'),
                         dtype=np.uint8)


def decode_strings(arr):
    return json.loads(np.asarray(arr, dtype=np.uint8).tobytes().decode(
        'utf-8'))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--wav-dir', required=True)
    p.add_argument('--rttm', help='RTTM annotation file')
    p.add_argument('--manifest', help='JSON {rec: {spk: [[b, e], ...]}}')
    p.add_argument('--out', required=True, help='output shard path')
    p.add_argument('--aux-size', type=int, default=513)
    p.add_argument('--embedding-kind', default='gate',
                   choices=['gate', 'mel'])
    p.add_argument('--enrollment', default='auto',
                   help="'auto' or a directory of <spk>.wav files")
    p.add_argument('--transcripts', help='JSON {rec: {spk: text}}')
    p.add_argument('--slots', type=int, default=None,
                   help='fixed speaker slots (model ts_vad)')
    p.add_argument('--sample-rate', type=int, default=None)
    args = p.parse_args(argv)
    if bool(args.rttm) == bool(args.manifest):
        p.error('exactly one of --rttm / --manifest is required')
    ids = import_corpus(
        args.out, args.wav_dir, args.rttm or args.manifest,
        aux_size=args.aux_size, embedding_kind=args.embedding_kind,
        enrollment=args.enrollment, transcripts=args.transcripts,
        num_speaker_slots=args.slots,
        expected_sample_rate=args.sample_rate)
    print(f'{len(ids)} recordings -> {args.out}')


if __name__ == '__main__':
    main()
