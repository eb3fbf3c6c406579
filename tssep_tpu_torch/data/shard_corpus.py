"""Reader over native shard corpora: port of ``tssep_tpu/data/shard_corpus.py``
on the port's ``runtime/native.py`` ``ShardReader``; it reads shards that
either package wrote.

Satisfies the reader contract the model expects (same as ``DummyReader``,
reference ``tssep/data.py:58-146``): ``reader(dataset_name, pre_load_apply,
load_keys)`` -> lazy dataset of example dicts — but backed by shard files
written by ``tssep_tpu_torch.data.simulate.simulate_corpus`` (or any external
preparation step using ``ShardWriter``), with lazy per-example payload reads
so hour-scale corpora never fully materialize in memory.
"""

from __future__ import annotations

import dataclasses

from tssep_tpu_torch.data import pipeline

__all__ = ['ShardCorpusReader']


@dataclasses.dataclass
class ShardCorpusReader:
    train_shard: str = None
    validate_shard: str = None
    eval_shard: str = None

    train_dataset_name: str = 'train'
    validate_dataset_name: str = 'validate'
    domain_adaptation_src_dataset_name: str = 'validate'
    eval_dataset_name: str = 'eval'

    sample_rate: int = 16000
    aux_size: int = 100

    def _shard_for(self, dataset_name):
        if self.train_dataset_name in dataset_name or 'train' in dataset_name:
            return self.train_shard
        if (self.validate_dataset_name in dataset_name
                or 'validate' in dataset_name or 'dev' in dataset_name):
            return self.validate_shard or self.train_shard
        return self.eval_shard or self.validate_shard or self.train_shard

    def __call__(self, dataset_name, pre_load_apply=None, load_keys=()):
        from tssep_tpu_torch.runtime.native import ShardReader
        shard = self._shard_for(dataset_name)
        assert shard is not None, dataset_name
        reader = ShardReader(shard)
        example_ids = sorted({k.split('/', 1)[0] for k in reader.keys()})

        def load(example_id):
            def get(field):
                return reader[f'{example_id}/{field}']

            obs = get('observation')
            ex = {
                'example_id': example_id,
                'num_samples': obs.shape[-1],
                'audio_data': {
                    'observation': obs,
                    'vad': get('vad').astype(bool),
                },
                'auxInput': get('auxInput'),
                'dataset': dataset_name,
            }
            if 'speaker_reverberation_early_ch0' in load_keys:
                ex['audio_data']['speaker_reverberation_early_ch0'] = get(
                    'speaker_reverberation_early_ch0')
            # optional fields written by data.import_corpus
            from tssep_tpu_torch.data.import_corpus import decode_strings
            for field in ('transcription', 'speaker_ids'):
                if f'{example_id}/{field}' in reader._index:
                    ex[field] = decode_strings(get(field))
            return ex

        # Lazy: the list holds ids; payloads load in the map stage (which
        # the prefetch pipeline parallelizes).
        ds = pipeline.new(example_ids).map(load)
        if pre_load_apply is not None:
            ds = pre_load_apply(ds)
        return ds

    class data_hooks:
        @staticmethod
        def pre_net(ex):
            return ex
