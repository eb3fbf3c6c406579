"""The port's distribution (``tssep_tpu_torch/dist``) against ``tssep_tpu/dist``,
in one process: the rank grid against JAX's ``make_mesh`` device grid on the
suite's 8 virtual CPU devices, ``_param_spec`` and ``param_shardings`` on
every named parameter of a small model, ``host_shard_dataset`` example for
example on ``DummyReader`` examples (and its index-level resume), the rows a
rank takes of a batch and of every per-example draw (``batch_rand``, the
sharded on-device simulator) seen from each rank of a mesh made without a
process group, ``initialize`` under ``TSSEP_MULTIHOST`` and a failing
rendezvous, and the item-4b raises of ``'model' > 1``. Several processes:
``tests/test_torch_port_multihost.py``.
"""

import itertools
import socket

import jax
import numpy as np
import pytest
import torch

from tssep_tpu.data import dummy as jax_dummy
from tssep_tpu.dist import mesh as jax_mesh
from tssep_tpu.dist import multihost as jax_multihost
from tssep_tpu.tasks.model import Model as JaxModel
from tssep_tpu.train.checkpoint import _path_str, params_to_named
from tssep_tpu_torch.data import dummy, pipeline
from tssep_tpu_torch.data.device_sim import (DeviceMeetingSimulator,
                                             DeviceSimDataset)
from tssep_tpu_torch.dist import mesh as mesh_lib
from tssep_tpu_torch.dist import multihost
from tssep_tpu_torch.eval.driver import ChunkedMaskEstimator
from tssep_tpu_torch.nn.rnnp import inverted_dropout
from tssep_tpu_torch.tasks.model import Model
from tssep_tpu_torch.train.trainer import Trainer, step_generator

CONFIG = {'fe': {'size': 64, 'shift': 32, 'window_length': 64},
          'reader': {'sample_rate': 1000, 'aux_size': 33},
          'mask_estimator': {'units': 4, 'projs': 6, 'combination': 'mul',
                             'ts_vad': 8, 'aux_net_output_size': 33}}


# -- the rank grid and the sharding rules, against JAX --------------------------

@pytest.mark.parametrize('data,model', [(4, 1), (2, 2)])
def test_rank_grid_as_jax(data, model):
    """Rank r sits where JAX's mesh puts device r; the data axis of a rank
    spans the ranks of its model index."""
    want = np.vectorize(lambda d: d.id)(
        jax_mesh.make_mesh(data * model, model_parallel=model).devices)
    for rank in range(data * model):
        mesh = mesh_lib.make_mesh(data * model, model, rank=rank)
        np.testing.assert_array_equal(mesh.grid, want)
        assert mesh.shape == {'data': data, 'model': model}
        d, m = mesh.coords
        assert want[d, m] == rank
        assert mesh.shard == mesh_lib.RowShard(d, data)
        assert rank in want[:, m]


def test_param_spec_as_jax():
    """Every named parameter of a small model takes JAX's spec, at model
    sizes 1, 2 and 4, and ``param_shardings`` JAX's on a (2, 2) mesh."""
    jm = JaxModel.new(CONFIG)
    shapes = {k: v.shape for k, v in params_to_named(jax.eval_shape(
        jm.init_params, jax.random.PRNGKey(0))).items()}
    ours = Model.from_config(CONFIG, device='cpu')
    assert set(ours.state_dict()) == set(shapes)
    for name, shape in shapes.items():
        for size in (1, 2, 4):
            assert mesh_lib._param_spec(name, shape, size) == tuple(
                jax_mesh._param_spec(name, shape, size)), (name, size)
    want = jax.tree_util.tree_flatten_with_path(jax_mesh.param_shardings(
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)),
        jax_mesh.make_mesh(4, model_parallel=2)))[0]
    got = mesh_lib.param_shardings(ours, mesh_lib.make_mesh(4, 2, rank=0))
    assert got == {_path_str(path): tuple(s.spec) for path, s in want}
    assert any(got.values())
    assert not any(mesh_lib.param_shardings(
        ours, mesh_lib.make_mesh(2, rank=1)).values())


def _ids(ds):
    return [ex['example_id'] for ex in ds]


@pytest.mark.parametrize('n', [2, 3])
@pytest.mark.parametrize('equalize', [True, False])
def test_host_shard_dataset_as_jax(n, equalize):
    """Example for example JAX's share of each process, its length, and a
    resume from every position within it."""
    ours = dummy.DummyReader(sample_rate=100, train_examples=7)('train')
    ref = jax_dummy.DummyReader(sample_rate=100, train_examples=7)('train')
    for index in range(n):
        got = multihost.host_shard_dataset(ours, n, index, equalize)
        want = jax_multihost.host_shard_dataset(ref, n, index, equalize)
        assert _ids(got) == _ids(want)
        assert len(got) == len(want) == len(_ids(want))
        for start in range(len(got) + 1):
            assert [ex['example_id'] for ex in got.iter_from(start)] == \
                _ids(want)[start:]
    assert multihost.host_shard_dataset(ours, 1, 0) is ours


def test_host_shard_after_the_shuffle_deals_the_global_batches():
    """Dealt after the shuffle and batched by the share of the batch
    size, the ranks' k-th batches hold the one-process k-th batch's
    examples, row j of rank r being its row j * n + r."""
    examples = [{'example_id': str(i)} for i in range(12)]

    def batches(ds, bs):
        return [[ex['example_id'] for ex in b]
                for b in ds.batch(bs, drop_last=True)]

    whole = batches(pipeline.new(examples).shuffle(seed=3), 4)
    shares = [batches(multihost.host_shard_dataset(
        pipeline.new(examples).shuffle(seed=3), 2, r), 2) for r in range(2)]
    for k, batch in enumerate(whole):
        assert [shares[r][k][j] for j in range(2) for r in range(2)] == batch


# -- a rank's rows: batches and draws -----------------------------------------

def test_shard_batch_rows_and_divisibility():
    batch = {'x': torch.arange(12).reshape(6, 2), 'y': np.arange(6),
             'names': [str(i) for i in range(6)], 'reference_channel': 0}
    parts = [mesh_lib.shard_batch(batch, mesh_lib.make_mesh(3, rank=r))
             for r in range(3)]
    for r, part in enumerate(parts):
        np.testing.assert_array_equal(part['x'], batch['x'][r::3])
        np.testing.assert_array_equal(part['y'], batch['y'][r::3])
        assert part['names'] == batch['names'][r::3]
        assert part['reference_channel'] == 0
    stacked = torch.stack([p['x'] for p in parts])
    assert torch.equal(stacked.transpose(0, 1).reshape(6, 2), batch['x'])
    with pytest.raises(ValueError, match='divisible'):
        mesh_lib.shard_batch(batch, mesh_lib.make_mesh(4, rank=0))


def _rows(full, size, index, examples):
    k = full.shape[0] // (examples * size)
    return full.reshape(examples, size, k, *full.shape[1:])[:, index] \
        .reshape(examples * k, *full.shape[1:])


@pytest.mark.parametrize('draw', [torch.rand, torch.randn])
@pytest.mark.parametrize('k', [1, 3])
def test_sharded_draws_are_the_rows_of_the_global_draw(draw, k):
    """A rank's draw of b examples of k rows each is its rows of the draw
    one process makes for the global batch, draw after draw."""
    size, b = 3, 2
    plain = torch.Generator().manual_seed(5)
    first = draw((size * b * k, 4), generator=plain)
    second = draw((size * b * k, 2), generator=plain)
    for index in range(size):
        gen = mesh_lib.ShardedGenerator('cpu', mesh_lib.RowShard(index, size),
                                        b).manual_seed(5)
        assert torch.equal(mesh_lib.batch_rand(gen, (b * k, 4), draw),
                           _rows(first, size, index, b))
        assert torch.equal(mesh_lib.batch_rand(gen, (b * k, 2), draw),
                           _rows(second, size, index, b))
    gen = mesh_lib.ShardedGenerator('cpu', mesh_lib.RowShard(0, size), b)
    with pytest.raises(ValueError, match='over a batch of 2'):
        mesh_lib.batch_rand(gen, (3, 4))


def test_step_generator_and_dropout_under_a_shard():
    """The trainer's step generator under a mesh, through the dropout
    between layers: each rank keeps its rows of one process's mask."""
    h = torch.ones(4 * 3, 5, 2)
    want = inverted_dropout(h, 0.5, step_generator('cpu', 0, 7, 1))
    parts = [inverted_dropout(h[:6], 0.5, step_generator(
        'cpu', 0, 7, 1, shard=mesh_lib.RowShard(r, 2), examples=2))
        for r in range(2)]
    for r, part in enumerate(parts):
        assert torch.equal(part, _rows(want, 2, r, 2))
    plain = step_generator('cpu', 0, 7, 1)
    assert type(plain) is torch.Generator


def test_sharded_simulator_batches_are_the_rows_of_the_global_batch():
    sim = DeviceMeetingSimulator(sample_rate=8000, duration=0.1,
                                 num_speakers=3, aux_size=17,
                                 enroll_seconds=0.05)
    whole = itertools.islice(DeviceSimDataset(sim, 4, seed=3, device='cpu'),
                             2)
    shares = [itertools.islice(DeviceSimDataset(
        sim, 4, seed=3, device='cpu', shard=mesh_lib.RowShard(r, 2)), 2)
        for r in range(2)]
    for want, *parts in zip(whole, *shares):
        for key in ('observation', 'auxInput', 'Vad'):
            got = torch.stack([p[key] for p in parts], 1).reshape(
                want[key].shape)
            assert torch.equal(got, want[key]), key
        assert parts[0]['dataset'] == ['train'] * 2
    with pytest.raises(ValueError, match='divisible'):
        next(iter(DeviceSimDataset(sim, 3, device='cpu',
                                   shard=mesh_lib.RowShard(0, 2))))


def test_global_batch_from_local_and_mesh_errors():
    mesh = mesh_lib.make_mesh()
    assert mesh.shape == {'data': 1, 'model': 1} and mesh.rank == 0
    batch = {'x': torch.ones(3, 2), 'names': ['a', 'b', 'c']}
    assert multihost.global_batch_from_local(batch, mesh) is batch
    with pytest.raises(ValueError, match='per-process share'):
        multihost.global_batch_from_local(
            batch, mesh_lib.make_mesh(2, rank=0))
    with pytest.raises(ValueError, match='start 2 processes'):
        mesh_lib.make_mesh(2)
    with pytest.raises(ValueError, match='no process group'):
        mesh_lib.gather_rows(torch.ones(2), mesh_lib.make_mesh(2, rank=0))
    # without a process group every collective is the identity
    t = torch.arange(3.)
    assert multihost.all_reduce(t) is t
    assert torch.equal(multihost.all_gather(t), t[None])
    assert multihost.all_gather_object('x') == ['x']
    np.testing.assert_array_equal(multihost.all_reduce_host([1., 2.]),
                                  [1., 2.])


# -- 'model' > 1 is item 4b ---------------------------------------------------

def test_model_axis_is_item_4b(tmp_path):
    model = Model.from_config(CONFIG, device='cpu')
    with pytest.raises(NotImplementedError, match='item 4b'):
        Trainer(model, tmp_path, mesh={'data': 1, 'model': 2})
    with pytest.raises(NotImplementedError, match='item 4b'):
        mesh_lib.shard_params(model, mesh_lib.make_mesh(4, 2, rank=0))
    with pytest.raises(NotImplementedError, match='item 4b'):
        ChunkedMaskEstimator(model, mesh=mesh_lib.make_mesh(4, 2, rank=0))
    # a data axis of this one process is a mesh of one rank
    trainer = Trainer(model, tmp_path, mesh={'data': None})
    assert trainer.data_parallel_size == 1
    assert trainer.mesh.shape == {'data': 1, 'model': 1}


# -- initialize --------------------------------------------------------------

@pytest.fixture
def clean_env(monkeypatch):
    for var in ('TSSEP_MULTIHOST', 'MASTER_ADDR', 'MASTER_PORT', 'RANK',
                'WORLD_SIZE', 'LOCAL_RANK'):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(multihost, '_initialized', False)
    assert not torch.distributed.is_initialized()
    return monkeypatch


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_initialize_single_process_and_forced(clean_env):
    multihost.initialize()           # nothing names a group: one process
    assert multihost.is_initialized()
    assert not torch.distributed.is_initialized()
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)
    clean_env.setattr(multihost, '_initialized', False)
    clean_env.setenv('TSSEP_MULTIHOST', '0')
    clean_env.setenv('WORLD_SIZE', '2')
    multihost.initialize(device='cpu')     # =0 wins over the environment
    assert multihost.is_initialized()
    assert not torch.distributed.is_initialized()
    clean_env.setattr(multihost, '_initialized', False)
    clean_env.setenv('TSSEP_MULTIHOST', '1')
    clean_env.delenv('WORLD_SIZE')
    with pytest.raises(ValueError, match='MASTER_ADDR|RANK|WORLD_SIZE'):
        multihost.initialize(device='cpu')   # =1 attempts, and fails loudly
    assert not multihost.is_initialized()
    assert multihost.default_backend('cpu') == 'gloo'
    assert multihost.default_backend() == 'nccl'


def test_initialize_raises_when_the_named_rendezvous_fails(clean_env):
    """The environment names two processes; the other never comes."""
    clean_env.setenv('MASTER_ADDR', '127.0.0.1')
    clean_env.setenv('MASTER_PORT', str(_free_port()))
    clean_env.setenv('WORLD_SIZE', '2')
    clean_env.setenv('RANK', '1')
    with pytest.raises((RuntimeError, TimeoutError, ValueError)):
        multihost.initialize(device='cpu', timeout=2)
    assert not multihost.is_initialized()
    assert not torch.distributed.is_initialized()
