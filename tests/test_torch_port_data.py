"""The port's data side against ``tssep_tpu``'s.

``tssep_tpu_torch/data/pipeline.py`` against ``tssep_tpu/data/pipeline.py``
(each operation, prefetch dropping a failing example, catch),
``DummyReader``'s examples, and ``Model.prepare_*_dataset`` with
``collate_fn``: the same examples and batches, bit for bit and in the same
order, also for a ragged batch with its ``_sample_mask`` / ``_frame_mask``.
The model is the toy recipe's TS-VAD stage at ``tests/test_exp.py``'s
reduced sizes.
"""

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tssep_tpu.data import dummy as jax_dummy
from tssep_tpu.data import pipeline as jax_pipeline
from tssep_tpu.tasks.model import Model as JaxModel
from tssep_tpu_torch.data import dummy, pipeline
from tssep_tpu_torch.tasks.model import Model

sys.path.insert(0, str(Path(__file__).parent))
from test_exp import _load_reduced  # noqa: E402

PIPELINES = {'jax': jax_pipeline, 'port': pipeline}


def _fails_on(bad):
    def fn(x):
        if x in bad:
            raise ValueError(x)
        return x * 2
    return fn


#: (name, function of a pipeline module -> the list the dataset yields)
OPS = [
    ('map batch', lambda p: list(p.new(range(10)).map(lambda x: x * 2)
                                 .batch(3))),
    ('batch drop_last', lambda p: list(p.new(range(10)).batch(3, True))),
    ('shuffle reshuffle', lambda p: (lambda ds: [list(ds), list(ds)])(
        p.new(range(20)).shuffle(reshuffle=True, seed=3))),
    ('shuffle once', lambda p: (lambda ds: [list(ds), list(ds)])(
        p.new(range(20)).shuffle(seed=5))),
    ('sort tile', lambda p: list(p.new([3, 1, 2]).sort(lambda x: -x)
                                 .tile(2))),
    ('prefetch order', lambda p: list(p.new(range(50)).map(lambda x: x + 1)
                                      .prefetch(4, 8))),
    ('prefetch drops', lambda p: list(p.new(range(12)).map(
        _fails_on({0, 5, 9})).prefetch(2, 4, catch_filter_exception=True))),
    ('catch', lambda p: list(p.new(range(6)).map(_fails_on({2}))
                             .map(lambda x: x + 1).catch())),
    ('lengths', lambda p: [len(p.new(range(10)).batch(4)),
                           len(p.new(range(10)).batch(4, True)),
                           len(p.new(range(3)).tile(3))]),
]


@pytest.mark.parametrize('op', [op for _, op in OPS], ids=[n for n, _ in OPS])
def test_pipeline_op_as_jax(op):
    assert op(pipeline) == op(jax_pipeline)


#: Chains a training run resumes through (``Trainer.train``): the prepared
#: examples shuffled anew each pass, batched, mapped and maybe prefetched.
RESUME_CHAINS = {
    'shuffle batch map': lambda p, f: p.new(range(11)).map(f).shuffle(
        reshuffle=True, seed=4).batch(3).map(f),
    'shuffle once': lambda p, f: p.new(range(7)).shuffle(seed=2).map(f),
    'prefetch': lambda p, f: p.new(range(9)).map(f).shuffle(
        reshuffle=True).batch(2).map(f).prefetch(2, 4).map(f),
    'catch': lambda p, f: p.new(range(8)).shuffle(reshuffle=True).map(f)
    .catch(),
}


@pytest.mark.parametrize('start', [0, 2, 9, 23])
@pytest.mark.parametrize('chain', list(RESUME_CHAINS))
def test_iter_from_resumes_where_a_pass_stood(chain, start):
    """``tile(None).iter_from(start)`` yields what the endless stream
    yields after its first ``start`` items, and the last map runs on no
    skipped item."""
    calls = []

    def f(x):
        calls.append(x)
        return x if isinstance(x, list) else x * 2

    want = list(itertools.islice(
        iter(RESUME_CHAINS[chain](pipeline, f).tile(None)), start, start + 12))
    ds = RESUME_CHAINS[chain](pipeline, f).tile(None)
    last = []
    got = list(itertools.islice(ds.map(lambda x: last.append(x) or x)
                                .iter_from(start), 12))
    assert got == want
    assert last == want


def test_prefetch_raises_without_catch():
    for p in PIPELINES.values():
        with pytest.raises(ValueError):
            list(p.new(range(6)).map(_fails_on({4})).prefetch(2, 4))


def _same(a, b):
    """Two examples (nested dicts of arrays and host values) equal bit for
    bit, tensors read as arrays."""
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (np.ndarray, torch.Tensor)) or hasattr(a, 'shape'):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize('dataset', ['train', 'validate'])
@pytest.mark.parametrize('load_keys',
                         [(), ('speaker_reverberation_early_ch0',)])
def test_dummy_reader_as_jax(dataset, load_keys):
    kw = dict(sample_rate=32, aux_size=33, train_examples=3, num_channels=2)
    ours = list(dummy.DummyReader(**kw)(dataset, load_keys=load_keys))
    want = list(jax_dummy.DummyReader(**kw)(dataset, load_keys=load_keys))
    assert len(ours) == len(want) == (3 if dataset == 'train' else 4)
    for a, b in zip(ours, want):
        _same(a, b)
    np.testing.assert_array_equal(dummy.staircase_vad(50, 4),
                                  jax_dummy.staircase_vad(50, 4))


def _models(stage='tsvad'):
    cfg = _load_reduced(f'init_cfg_{stage}.yaml', '/nonexistent')
    model_cfg = cfg['eg']['trainer']['model']
    return (Model.from_config(model_cfg, storage_dtype=torch.float32,
                              device='cpu'), JaxModel.new(model_cfg))


@pytest.fixture(scope='module')
def models():
    return {stage: _models(stage) for stage in ('tsvad', 'tssep')}


@pytest.mark.parametrize('stage', ['tsvad', 'tssep'])
@pytest.mark.parametrize('kind,kwargs', [
    ('train', dict(batch_size=2)),
    ('train', dict(batch_size=1, sort=True, prefetch=False)),
    ('validate', dict(batch_size=3)),
    ('validate', dict(batch_size=None, prefetch=False)),
], ids=['train batch 2', 'train sorted', 'validate batch 3', 'validate single'])
def test_prepared_batches_as_jax(models, stage, kind, kwargs):
    ours, jax_model = models[stage]
    got = list(getattr(ours, f'prepare_{kind}_dataset')(device=False,
                                                         **kwargs))
    want = list(getattr(jax_model, f'prepare_{kind}_dataset')(device=False,
                                                              **kwargs))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _same(a, b)
    # two epochs of a reshuffled training set: the same order again
    if kind == 'train' and not kwargs.get('sort'):
        ds_a = ours.prepare_train_dataset(device=False, **kwargs)
        ds_b = jax_model.prepare_train_dataset(device=False, **kwargs)
        for a, b in zip(list(ds_a.tile(2)), list(ds_b.tile(2))):
            _same(a, b)


def _ragged_reader(package, pipe):
    """A ``DummyReader`` whose examples are cut to ragged lengths."""
    base = package.DummyReader(sample_rate=32, aux_size=33,
                               validate_examples=3)

    def reader(name, pre_load_apply=None, load_keys=()):
        exs = list(base(name, load_keys=load_keys))
        for ex, n in zip(exs, (160, 97, 130)):
            for k, v in ex['audio_data'].items():
                ex['audio_data'][k] = v[..., :n]
            ex['num_samples'] = n
        ds = pipe.new(exs)
        return ds if pre_load_apply is None else pre_load_apply(ds)
    reader.validate_dataset_name = base.validate_dataset_name
    return reader


@pytest.mark.parametrize('stage', ['tsvad', 'tssep'])
def test_ragged_batch_masks_as_jax(models, stage):
    ours, jax_model = models[stage]
    got = next(iter(ours.prepare_validate_dataset(
        device=False, batch_size=3, reader=_ragged_reader(dummy, pipeline))))
    want = next(iter(jax_model.prepare_validate_dataset(
        device=False, batch_size=3,
        reader=_ragged_reader(jax_dummy, jax_pipeline))))
    _same(got, want)
    assert got['_sample_mask'].sum(-1).ravel().tolist() == [160, 97, 130]
    if 'Vad' in got:
        assert got['_frame_mask'].shape[-1] == got['Vad'].shape[-1]


def test_example_to_device_moves_the_device_keys(models):
    ours, _ = models['tsvad']
    host = next(iter(ours.prepare_train_dataset(device=False, batch_size=2)))
    ex = next(iter(ours.prepare_train_dataset(batch_size=2)))
    for k in ('observation', 'auxInput', 'Vad'):
        assert isinstance(ex[k], torch.Tensor)
        assert ex[k].device == torch.device('cpu')
        np.testing.assert_array_equal(ex[k].numpy(),
                                      host[k].astype(np.float32))
    assert isinstance(ex['vad'], np.ndarray)        # not a device key
    assert ex['example_id'] == host['example_id']
    # one process: the host shard is the whole dataset
    sharded = ours.prepare_validate_dataset(host_shard=True, batch_size=2,
                                            prefetch=False)
    assert [b['example_id'] for b in sharded] == [
        b['example_id'] for b in ours.prepare_validate_dataset(
            batch_size=2, prefetch=False)]
