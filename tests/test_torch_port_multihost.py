"""Several processes on ``torch.distributed``: gloo ranks on 127.0.0.1, each
a process with one device (the CPU), against one process and against
``tssep_tpu``.

Fast tier: one group of 2 ranks (spawned once for the module) makes its
mesh from the process group, trains the reduced TS-VAD stage
(``tests/test_exp.py``'s sizes, 8 examples, batch 4) for 2 iterations
through ``Experiment.train`` into shared storage dirs, without and with
``random_speaker_order``, hits the batch-divisibility ``ValueError``,
calibrates the activity threshold with half the recordings on each rank,
and runs ``ChunkedMaskEstimator`` with the chunks dealt over the ranks.
Meanwhile this process runs the one-process references: the same
trainings (losses at rtol 1e-5, parameters at JAX's tolerances,
``tests/test_multihost.py:90-103``, checkpoints and metrics written once),
the calibration on all the recordings (and JAX's), and the chunked
estimator without a mesh (and JAX's, at 1e-4).

Slow tier, mirrors of ``tests/test_dist_train.py`` and
``tests/test_multihost.py``: gradient accumulation, validation with the
partial batch dropped, metrics, checkpoints and resume of 2 ranks against
one process, and the CLI under ``python -m torch.distributed.run``.

The ranks import neither JAX nor ``tssep_tpu``: everything they need comes
as arguments or files (the configurations, the eval model's weights).
Every group has a collective timeout, the test a deadline, and a failing
or late rank takes its peers down.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from tssep_tpu_torch.compat.from_jax import load_named
from tssep_tpu_torch.config.configurable import dump_yaml, from_config
from tssep_tpu_torch.dist import mesh as mesh_lib
from tssep_tpu_torch.dist import multihost
from tssep_tpu_torch.eval import driver
from tssep_tpu_torch.tasks.model import Model
from tssep_tpu_torch.train.experiment import Experiment

REPO = Path(__file__).resolve().parents[1]
F32 = torch.float32
#: Seconds: a collective that waits longer raises; a group that takes
#: longer is killed.
COLLECTIVE_TIMEOUT = 120
DEADLINE = 600
ATOL = 1e-4


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _start(jobs, tmp, nprocs=2):
    """Starts ``nprocs`` ranks running ``jobs`` (see ``_rank_main``)."""
    return mp.start_processes(
        _rank_main, args=(_free_port(), str(tmp), jobs, nprocs),
        nprocs=nprocs, join=False, start_method='spawn')


def _join(context):
    """Waits for every rank until ``DEADLINE``; a rank that fails takes
    the others down (``ProcessRaisedException``), a late group is
    killed."""
    deadline = time.monotonic() + DEADLINE
    try:
        while not context.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f'ranks still running after {DEADLINE} s')
    finally:
        for p in context.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


def _named(model):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def _experiment(cfg):
    return from_config(Experiment.get_config(cfg), device='cpu',
                       storage_dtype=F32)


def _calibration_set():
    rng = np.random.default_rng(0)
    refs = [rng.random((3, 200)) > 0.7 for _ in range(4)]
    acts = [0.25 + 0.2 * r + 0.05 * rng.standard_normal(r.shape)
            for r in refs]
    return acts, refs


def _eval_model(tmp, channels):
    model = Model.from_config(_eval_config(channels), storage_dtype=F32,
                              device='cpu')
    with np.load(Path(tmp) / 'eval_params.npz') as z:
        return load_named(model, dict(z))


def _recording(model):
    ex = next(iter(model.prepare_validate_dataset(device=False,
                                                  prefetch=False)))
    return ex['observation'], ex['auxInput']


def _eval_config(channels):
    return {'fe': {'size': 64, 'shift': 32, 'window_length': 64},
            'reader': {'sample_rate': 1000, 'aux_size': 33,
                       'num_channels': channels},
            'mask_estimator': {'units': 4, 'projs': 5, 'combination': 'mul',
                               'ts_vad': 8, 'aux_net_output_size': 33,
                               'num_averaged_permutations': 1,
                               'random_speaker_order': False}}


CHUNKED = dict(chunk_frames=40, hop_frames=20, batch_chunks=3)


def _rank_main(rank, port, tmp, jobs, nprocs):
    """One rank: joins the gloo group and runs ``jobs``, a list of (kind,
    name, argument); writes what it found to ``<tmp>/rank<rank>.pt``.
    Kinds: 'train' (``Experiment.train`` of a configuration; the trained
    parameters), 'raises' (the message of the ValueError it raises),
    'calibrate' (this rank's share of ``_calibration_set``), 'chunked'
    (``ChunkedMaskEstimator`` over the mesh on the recording of
    ``_eval_model``)."""
    torch.set_num_threads(1)
    multihost.initialize(f'127.0.0.1:{port}', nprocs, rank, backend='gloo',
                         timeout=COLLECTIVE_TIMEOUT)
    mesh = mesh_lib.make_mesh()
    out = {'mesh': (mesh.grid.tolist(), mesh.coords, mesh.shape,
                    multihost.process_count(), multihost.backend())}
    for kind, name, arg in jobs:
        if kind == 'train':
            eg = _experiment(arg)
            out[name] = (eg.train(), _named(eg.trainer.model))
        elif kind == 'raises':
            try:
                _experiment(arg).train()
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
        elif kind == 'calibrate':
            acts, refs = _calibration_set()
            out[name] = driver.calibrate_threshold(
                acts[rank::nprocs], refs[rank::nprocs], **arg)
        elif kind == 'chunked':
            model = _eval_model(tmp, arg)
            obs, aux = _recording(model)
            chunked = driver.ChunkedMaskEstimator(model, mesh=mesh, **CHUNKED)
            masks, activity = chunked(
                driver.EvalDriver(model).stft(obs), aux)
            out[name] = (chunked.batch_chunks, masks, activity)
    torch.save(out, Path(tmp) / f'rank{rank}.pt')
    torch.distributed.destroy_process_group()


def _results(tmp, nprocs=2):
    return [torch.load(Path(tmp) / f'rank{r}.pt', weights_only=False)
            for r in range(nprocs)]


# -- the configurations ---------------------------------------------------------

def _tsvad(storage, mesh, stop=2, rso=False, **eg):
    sys.path.insert(0, str(Path(__file__).parent))
    from test_exp import _load_reduced
    cfg = _load_reduced('init_cfg_tsvad.yaml', storage)['eg']
    trainer = cfg['trainer']
    trainer['stop_trigger'] = [stop, 'iteration']
    trainer['mesh'] = mesh
    trainer['model']['mask_estimator']['random_speaker_order'] = rso
    trainer['model']['reader']['train_examples'] = 8
    cfg['train_batchsize'] = 4
    cfg['validation_batchsize'] = 4
    for key, value in eg.items():
        if key in ('virtual_minibatch_size', 'checkpoint_trigger'):
            trainer[key] = value
        elif key == 'validate_examples':
            trainer['model']['reader'][key] = value
        else:
            cfg[key] = value
    return cfg


def _train_losses(storage, key='train/loss'):
    out = {}
    for line in (Path(storage) / 'metrics.jsonl').read_text().splitlines():
        rec = json.loads(line)
        if key in rec:
            out[rec['step']] = rec[key]
    return out


def _assert_same_training(storage2, storage1, params2, params1):
    """The 2-rank run against the one-process run: every logged loss at
    rtol 1e-5, the parameters at JAX's tolerances (Adam's 1/sqrt(v)
    amplifies the reduction order's noise on near-zero gradients)."""
    want = _train_losses(storage1)
    got = _train_losses(storage2)
    assert want and got.keys() == want.keys()
    for step in want:
        np.testing.assert_allclose(got[step], want[step], rtol=1e-5,
                                   err_msg=f'step {step}')
    assert params2.keys() == params1.keys()
    for k in params1:
        np.testing.assert_allclose(params2[k], params1[k], rtol=2e-2,
                                   atol=3e-3, err_msg=k)


# -- fast tier: one group for the module ---------------------------------------

@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    """The 2-rank group's results, with the one-process references this
    process computed while the ranks ran."""
    from tssep_tpu.tasks.model import Model as JaxModel
    from tssep_tpu.train.checkpoint import params_to_named
    import jax

    tmp = tmp_path_factory.mktemp('two_ranks')
    jm = JaxModel.new(_eval_config(1))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda leaf: rng.uniform(-1, 1, leaf.shape).astype(np.float32),
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)))
    np.savez(tmp / 'eval_params.npz', **params_to_named(params))

    train = {f'rso{int(rso)}': rso for rso in (False, True)}
    jobs = [('train', name, _tsvad(tmp / f'{name}_2', {'data': 2}, rso=rso))
            for name, rso in train.items()]
    jobs += [('raises', 'indivisible',
              _tsvad(tmp / 'indivisible', {'data': 2}, train_batchsize=3)),
             ('calibrate', 'calibration', {'smooth_kernel': 5}),
             ('chunked', 'chunked', 1)]
    context = _start(jobs, tmp)
    try:
        reference = {}
        for name, rso in train.items():
            eg = _experiment(_tsvad(tmp / f'{name}_1', None, rso=rso))
            reference[name] = (eg.train(), _named(eg.trainer.model))
    finally:
        _join(context)
    return tmp, _results(tmp), reference, (jm, params)


def test_two_ranks_make_the_mesh_of_the_group(two_ranks):
    _, ranks, _, _ = two_ranks
    for r, out in enumerate(ranks):
        grid, coords, shape, count, backend = out['mesh']
        assert grid == [[0], [1]] and coords == (r, 0)
        assert shape == {'data': 2, 'model': 1}
        assert (count, backend) == (2, 'gloo')


@pytest.mark.parametrize('name', ['rso0', 'rso1'])
def test_two_ranks_train_as_one_process(two_ranks, name):
    """Without and with ``random_speaker_order``: the per-example draws are
    each rank's rows of one process's, so the trajectories agree (a
    duplicated permutation shifts the loss at O(1e-2)); the ranks hold the
    same parameters; rank 0 alone wrote the checkpoints and the metrics."""
    tmp, ranks, reference, _ = two_ranks
    (it0, params0), (it1, params1) = ranks[0][name], ranks[1][name]
    assert it0 == it1 == reference[name][0] == 2
    for k in params0:
        np.testing.assert_array_equal(params0[k], params1[k], err_msg=k)
    _assert_same_training(tmp / f'{name}_2', tmp / f'{name}_1', params0,
                          reference[name][1])
    lines = (tmp / f'{name}_2' / 'metrics.jsonl').read_text().splitlines()
    assert len(lines) == len((tmp / f'{name}_1' / 'metrics.jsonl')
                             .read_text().splitlines())
    ckpts = tmp / f'{name}_2' / 'checkpoints'
    assert (ckpts / 'ckpt_latest.npz').exists()
    assert (ckpts / 'ckpt_best_loss.npz').exists()
    assert sorted(p.name for p in (tmp / f'{name}_2' / 'log').iterdir()) == \
        sorted(p.name for p in (tmp / f'{name}_1' / 'log').iterdir())


def test_batch_divisibility_error(two_ranks):
    _, ranks, _, _ = two_ranks
    for out in ranks:
        assert 'train_batchsize=3 must be set and divisible by the mesh ' \
               'data axis (2)' in out['indivisible']


def test_calibration_over_two_ranks(two_ranks):
    """Half the recordings on each rank: the all-reduced statistics pick
    the threshold of one process on all of them, and JAX's."""
    from tssep_tpu.eval import driver as jax_driver
    _, ranks, _, _ = two_ranks
    acts, refs = _calibration_set()
    one = driver.calibrate_threshold(acts, refs, smooth_kernel=5)
    want = jax_driver.calibrate_threshold(acts, refs, smooth_kernel=5)
    assert one == want
    for out in ranks:
        threshold, der = out['calibration']
        assert threshold == want[0]
        np.testing.assert_allclose(der, want[1], rtol=1e-12)
    alone = driver.calibrate_threshold(acts[::2], refs[::2], smooth_kernel=5)
    assert alone != want          # one rank's share alone picks another


def test_chunked_estimator_over_two_ranks(two_ranks):
    """7 chunks dealt over 2 ranks (``batch_chunks`` 3 rounded to 2: four
    calls, the last padded) give each rank the masks and activity of
    ``mesh=None`` and of JAX's estimator, at 1e-4."""
    from tssep_tpu.eval import driver as jax_driver
    from tssep_tpu.nn import rnnp as jax_rnnp
    tmp, ranks, _, (jm, params) = two_ranks
    model = _eval_model(tmp, 1)
    obs, aux = _recording(model)
    alone = driver.ChunkedMaskEstimator(model, **CHUNKED)
    stft = driver.EvalDriver(model).stft(obs)
    masks, activity = alone(stft, aux)
    saved = jax_rnnp.DEFAULT_UNROLL
    jax_rnnp.DEFAULT_UNROLL = 1     # the same arithmetic, compiled faster
    try:
        jd = jax_driver.ChunkedMaskEstimator(jm, **CHUNKED)
        want_masks, want_activity = jd(params, np.asarray(jm.fe.stft(obs)),
                                       aux)
    finally:
        jax_rnnp.DEFAULT_UNROLL = saved
    assert masks.shape[-2] > CHUNKED['chunk_frames'] * 3
    for out in ranks:
        batch_chunks, got_masks, got_activity = out['chunked']
        assert batch_chunks == 2
        for got, ref in ((got_masks, masks), (got_activity, activity),
                         (got_masks, want_masks),
                         (got_activity, want_activity)):
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


# -- slow tier --------------------------------------------------------------------

@pytest.mark.slow
def test_two_process_training_checkpoints_and_resume(tmp_path):
    """``tests/test_multihost.py`` and ``test_mesh_validation_and_metrics``:
    2 ranks train 3 iterations in a shared storage dir as one process does
    (losses, parameters), write the checkpoints and ``metrics.jsonl``
    once (validation and throughput in it), then resume to 5 as an
    uninterrupted one-process run of 5 does."""
    two, one = tmp_path / 'two', tmp_path / 'one'
    _join(_start([('train', 'run', _tsvad(two, {'data': 2}, stop=3))],
                 tmp_path))
    (it, params2), = [r['run'] for r in _results(tmp_path)[:1]]
    eg = _experiment(_tsvad(one, None, stop=3))
    assert eg.train() == it == 3
    _assert_same_training(two, one, params2, _named(eg.trainer.model))
    metrics = (two / 'metrics.jsonl').read_text()
    assert 'validation/mean_loss' in metrics
    assert 'examples_per_second' in metrics
    assert len(_train_losses(two, 'validation/mean_loss')) == 3
    assert (two / 'checkpoints' / 'ckpt_3.npz').exists()

    _join(_start([('train', 'resumed', _tsvad(two, {'data': 2}, stop=5))],
                 tmp_path))
    (it, params2), = [r['resumed'] for r in _results(tmp_path)[:1]]
    eg = _experiment(_tsvad(tmp_path / 'straight', None, stop=5))
    assert eg.train() == it == 5
    _assert_same_training(two, tmp_path / 'straight', params2,
                          _named(eg.trainer.model))


@pytest.mark.slow
def test_grad_accumulation_and_partial_validation_batch(tmp_path):
    """``virtual_minibatch_size`` 2 (the gradients all-reduced in each
    micro-step, clipped once) and 6 validation examples in batches of 4
    (3 a rank in batches of 2: the partial batch dropped) against one
    process with the same drop."""
    extra = dict(virtual_minibatch_size=2, validate_examples=6, stop=3)
    _join(_start([('train', 'run', _tsvad(tmp_path / 'two', {'data': 2},
                                          **extra))], tmp_path))
    (it, params2), = [r['run'] for r in _results(tmp_path)[:1]]
    eg = _experiment(_tsvad(tmp_path / 'one', None, **extra))
    assert eg.train() == it == 3
    _assert_same_training(tmp_path / 'two', tmp_path / 'one', params2,
                          _named(eg.trainer.model))
    got = _train_losses(tmp_path / 'two', 'validation/mean_loss')
    assert len(got) == 3 and all(map(np.isfinite, got.values()))


@pytest.mark.slow
def test_cli_under_torch_distributed_run(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node=2 -m
    tssep_tpu_torch.train.run train with cfg.yaml --cpu``: gloo ranks, the
    storage dir written once, by rank 0."""
    storage = tmp_path / 'tsvad'
    cfg = {'eg': _tsvad(storage, {'data': 2})}
    dump_yaml(cfg, tmp_path / 'cfg.yaml')
    env = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=str(REPO))
    cmd = [sys.executable, '-m', 'torch.distributed.run',
           '--nproc_per_node=2', f'--master_port={_free_port()}',
           '-m', 'tssep_tpu_torch.train.run', 'train', 'with',
           str(tmp_path / 'cfg.yaml'), '--cpu']
    proc = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=DEADLINE)
    assert proc.returncode == 0, proc.stderr[-4000:]
    info = json.loads((storage / 'host_info.json').read_text())
    assert (info['process_index'], info['process_count']) == (0, 2)
    assert (storage / 'checkpoints' / 'ckpt_latest.npz').exists()
    history = (storage / 'python_history.txt').read_text().splitlines()
    assert len(history) == 1
    assert len(_train_losses(storage)) == 2
