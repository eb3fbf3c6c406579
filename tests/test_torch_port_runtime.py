"""The port's training runtime against ``tssep_tpu``'s.

Checkpoints (``train/checkpoint.py``) load across the packages both ways;
the VAD->SEP warm start (``train/init_ckpt.py``) gives JAX's parameters on
one checkpoint, as ``tests/test_exp.py:184-227`` asserts; the reference's
``.pth`` names translate as JAX's do. In the port alone: 2 + 2 resumed
iterations equal 4 straight ones bit for bit; ``test_run``, validation,
retention, early stop and asynchronous checkpoints behave as
``tests/test_exp.py`` asserts; the CLI's flags and device choice; the
reports. Slow tier: the reduced TS-VAD stage trained through both
packages' ``Experiment`` (per-iteration losses and final parameters within
1e-4), and the two-stage recipe through the port's CLI and launchers in
subprocesses.

Sizes are ``tests/test_exp.py``'s reduced ones (units 2, projs 3, sample
rate 32, STFT 64/32), storage float32, on the CPU.
"""

import json
import os
import subprocess
import sys
import unittest.mock as mock
from pathlib import Path

import numpy as np
import pytest
import torch

from tssep_tpu.compat import torch_ckpt as jax_torch_ckpt
from tssep_tpu.config.configurable import from_config as jax_from_config
from tssep_tpu.train import checkpoint as jax_ckpt
from tssep_tpu.train import init_ckpt as jax_init
from tssep_tpu.train.experiment import Experiment as JaxExperiment
from tssep_tpu_torch.compat import torch_ckpt
from tssep_tpu_torch.config.configurable import dump_yaml, from_config
from tssep_tpu_torch.train import checkpoint as ckpt_lib
from tssep_tpu_torch.train import init_ckpt, run, track
from tssep_tpu_torch.train.experiment import Experiment
from tssep_tpu_torch.train.summary import ReviewSummary
from tssep_tpu_torch.train.trainer import Trainer

sys.path.insert(0, str(Path(__file__).parent))
from test_exp import _load_reduced, reduce_parameters  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
F32 = torch.float32


def _port_eg(stage, storage_dir, reader=None, **trainer):
    cfg = _load_reduced(f'init_cfg_{stage}.yaml', storage_dir)
    cfg['eg']['trainer'].update(trainer)
    cfg['eg']['trainer']['model']['reader'].update(reader or {})
    return from_config(Experiment.get_config(cfg['eg']), device='cpu',
                       storage_dtype=F32)


def _jax_eg(stage, storage_dir, **trainer):
    cfg = _load_reduced(f'init_cfg_{stage}.yaml', storage_dir)
    cfg['eg']['trainer'].update(trainer)
    return jax_from_config(JaxExperiment.get_config(cfg['eg']))


def _jax_params(jeg, seed=0):
    """A JAX params tree of ``jeg``'s model (``jax.eval_shape``: no JAX
    draw to compile), its values drawn by numpy from ``seed``."""
    import jax
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda leaf: rng.uniform(-0.2, 0.2, leaf.shape).astype(np.float32),
        jax.eval_shape(jeg.trainer.model.init_params,
                       jax.random.PRNGKey(0)))


def _named(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


# -- checkpoints across the packages ------------------------------------------

def test_jax_checkpoint_loads_into_the_port(tmp_path):
    params = _jax_params(_jax_eg('tsvad', tmp_path / 'jax'))
    path = jax_ckpt.save_checkpoint(tmp_path / 'ck', 7, params,
                                    opt_state={'mu': params},
                                    meta={'best_validation_loss': 0.5})
    peg = _port_eg('tsvad', tmp_path / 'port')
    peg.trainer.load(path)
    want = jax_ckpt.params_to_named(params)
    got = _named(peg.trainer.model)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert peg.trainer.iteration == 7
    assert peg.trainer.best_validation_loss == 0.5


def test_port_checkpoint_loads_into_jax(tmp_path):
    peg = _port_eg('tsvad', tmp_path / 'port')
    trainer = peg.trainer
    trainer.ensure_init()
    batch = next(iter(trainer.model.prepare_train_dataset(
        prefetch=False, batch_size=1)))
    trainer.train_step(batch)           # an optimizer state to write
    path = trainer.save(best=True)
    template = _jax_params(_jax_eg('tsvad', tmp_path / 'jax'), seed=1)
    params, _, meta = jax_ckpt.load_checkpoint(path,
                                               params_template=template)
    got = jax_ckpt.params_to_named(params)
    want = _named(trainer.model)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert meta['iteration'] == 1
    assert (path.parent / 'ckpt_best_loss.npz').resolve() == path
    assert (path.parent / 'ckpt_latest.npz').resolve() == path


def test_checkpoint_write_false_skips_io(tmp_path):
    model = torch.nn.Linear(3, 3)
    assert ckpt_lib.save_checkpoint(tmp_path / 'ck', 5, model,
                                    write=False) is None
    assert not (tmp_path / 'ck').exists()
    assert ckpt_lib.save_checkpoint(tmp_path / 'ck', 5, model).exists()


@pytest.mark.parametrize('kwargs', [{}, {'amsgrad': True},
                                    {'weight_decay': 0.1}],
                         ids=['adam', 'amsgrad', 'adamw'])
@pytest.mark.parametrize('every_k_steps', [1, 2])
def test_optimizer_state_round_trip(tmp_path, kwargs, every_k_steps):
    """Saving after 3 steps and loading into a fresh optimizer continues
    with the same bits as the optimizer that was not interrupted."""
    from tssep_tpu_torch.train.optimizer import Adam

    def setup():
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 3)
        return model, Adam(lr=0.1, **kwargs).make(model.parameters(),
                                                  every_k_steps)

    def step(model, opt, i):
        opt.zero_grad()
        x = torch.arange(8.0).reshape(2, 4) * (i + 1)
        model(x).square().sum().backward()
        opt.step()

    model, opt = setup()
    for i in range(3):
        step(model, opt, i)
    path = ckpt_lib.save_checkpoint(tmp_path, 3, model, optimizer=opt)
    step(model, opt, 3)
    model2, opt2 = setup()
    ckpt_lib.load_checkpoint(path, model2, opt2)
    step(model2, opt2, 3)
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)


# -- the VAD -> SEP warm start -------------------------------------------------

@pytest.mark.parametrize('mode', ['repeat', 'tile'])
def test_broadcast_param_as_jax(mode):
    p = np.arange(6.0).reshape(3, 2)
    got = init_ckpt.broadcast_param(p, (6, 4), mode)
    np.testing.assert_array_equal(
        got, jax_init.broadcast_param(p, (6, 4), mode))
    first = {'repeat': [0, 0, 1, 1, 2, 2], 'tile': [0, 1, 2, 0, 1, 2]}[mode]
    np.testing.assert_array_equal(
        init_ckpt.broadcast_param(np.array([[0.], [1.], [2.]]), (6, 1),
                                  mode).ravel(), first)


def test_vad2sep_warm_start_as_jax(tmp_path):
    """The TS-VAD head (8, projs) becomes the TS-SEP head (33 * 8, projs),
    each activity neuron repeated over its 33 bins; every parameter of
    both packages' warm-started TS-SEP model is the same."""
    vad_params = _jax_params(_jax_eg('tsvad', tmp_path / 'vad'))
    path = jax_ckpt.save_checkpoint(tmp_path / 'ck', 7, vad_params)
    w = jax_ckpt.params_to_named(vad_params)[
        'mask_estimator.post_net.linear2.weight']
    assert w.shape == (8, 3)

    warm = {'factory': 'tssep_tpu.train.init_ckpt.InitCheckPointVAD2Sep',
            'init_ckpt': str(path)}
    jsep = _jax_eg('tssep', tmp_path / 'jsep')
    jsep.init_ckpt = jax_from_config(warm)
    jsep.trainer.params = _jax_params(jsep, seed=1)    # the template
    jsep.init_ckpt(jsep)
    psep = _port_eg('tssep', tmp_path / 'psep')
    psep.init_ckpt = from_config(warm)
    assert isinstance(psep.init_ckpt, init_ckpt.InitCheckPointVAD2Sep)
    psep.trainer.ensure_init()
    psep.init_ckpt(psep)

    want = jax_ckpt.params_to_named(jsep.trainer.params)
    got = _named(psep.trainer.model)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    w_sep = got['mask_estimator.post_net.linear2.weight']
    assert w_sep.shape == (264, 3)
    np.testing.assert_array_equal(w_sep[:33], np.broadcast_to(w[0], (33, 3)))
    np.testing.assert_array_equal(w_sep[33:66],
                                  np.broadcast_to(w[1], (33, 3)))


@pytest.mark.parametrize('name', [
    'mask_estimator.pre_net.net.0.weight_ih_l0',
    'mask_estimator.pre_net.net.0.weight_hh_l0_reverse',
    'mask_estimator.pre_net.net.1.weight',
    'mask_estimator.post_net.birnn2.net.0.bias_ih_l0',
    'mask_estimator.post_net.birnn0.net.1.bias',
    'mask_estimator.post_net.birnn1.net.4.weight_ih_l0',
    'mask_estimator.post_net.birnn1.net.5.weight',
    'mask_estimator.post_net.linear2.weight',
    'mask_estimator.aux_net.net.2.weight',
    'mask_estimator.aux_net.net.4.bias'])
def test_reference_names_translate_as_jax(name):
    assert torch_ckpt.translate_torch_name(name) == \
        jax_torch_ckpt.translate_torch_name(name)


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    peg = _port_eg('tsvad', tmp_path / 'port')
    model = peg.trainer.model
    peg.trainer.ensure_init()
    named = _named(model)
    reference = {k.replace('.lstm0.', '.net.0.').replace('.proj0.', '.net.1.'):
                 torch.from_numpy(v) for k, v in named.items()}
    torch.save({'model': reference}, tmp_path / 'ckpt.pth')
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    torch_ckpt.load_torch_checkpoint(tmp_path / 'ckpt.pth', model)
    for k, v in _named(model).items():
        np.testing.assert_array_equal(v, named[k])


# -- the port's trainer ---------------------------------------------------

def _trainer(storage_dir, stop, checkpoint=2, **kwargs):
    """The reduced TS-VAD stage's trainer (2 validation examples, no
    snapshots unless asked) with its datasets, no threads."""
    kwargs.setdefault('create_snapshots', False)
    eg = _port_eg('tsvad', storage_dir, reader={'validate_examples': 2},
                  stop_trigger=[stop, 'iteration'],
                  checkpoint_trigger=[checkpoint, 'iteration'],
                  summary_trigger=[2, 'iteration'], **kwargs)
    trainer = eg.trainer
    model = trainer.model
    trainer.register_validation_hook(
        model.prepare_validate_dataset(prefetch=False, batch_size=2),
        max_checkpoints=eg.max_checkpoints)
    return trainer, model.prepare_train_dataset(prefetch=False,
                                                batch_size=1)


def _losses(storage_dir, key='train/loss'):
    return [r[key] for r in map(json.loads, (
        Path(storage_dir) / 'metrics.jsonl').read_text().splitlines())
        if key in r]


def test_resume_reproduces_an_uninterrupted_run(tmp_path):
    straight, data = _trainer(tmp_path / 'a', stop=4)
    assert straight.train(data) == 4
    first, data = _trainer(tmp_path / 'b', stop=2)
    assert first.train(data) == 2
    second, data = _trainer(tmp_path / 'b', stop=4)
    assert second.train(data, resume=True) == 4
    for (k, a), b in zip(straight.model.state_dict().items(),
                         second.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert _losses(tmp_path / 'a') == _losses(tmp_path / 'b')
    assert _losses(tmp_path / 'a', 'validation/mean_loss') == _losses(
        tmp_path / 'b', 'validation/mean_loss')


def test_train_and_train_steps_take_the_same_steps(tmp_path):
    """``train`` and ``train_steps`` run the same micro-steps: 2 iterations
    of 2 accumulated micro-steps each reach the same parameters."""
    looped, data = _trainer(tmp_path / 'a', stop=2, virtual_minibatch_size=2)
    assert looped.train(data) == 2
    stepped, data = _trainer(tmp_path / 'b', stop=2, virtual_minibatch_size=2)
    stepped.ensure_init()
    assert len(stepped.train_steps(data.tile(None), 2)) == 4
    assert stepped.iteration == 2
    for (k, a), b in zip(looped.model.state_dict().items(),
                         stepped.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_test_run_and_validation(tmp_path):
    trainer, data = _trainer(tmp_path, stop=2, create_snapshots=True)
    model = trainer.model
    val = model.prepare_validate_dataset(prefetch=False, batch_size=None)
    results = trainer.test_run(model.prepare_train_dataset(
        prefetch=False, sort=True, batch_size=1), val)
    assert len(results) == 4 and all(np.isfinite(r).all() for r in results)
    assert all(len(r) == 2 and r[1] > 0 for r in results[:2])
    mean, summary = trainer.validate()
    assert np.isfinite(mean) and summary.loss_count == 1
    assert mean == trainer.validate()[0]
    assert any(k.startswith('mask_spk') for k in summary.images)


def test_test_run_fails_on_a_non_replicating_loss(tmp_path):
    trainer, data = _trainer(tmp_path, stop=2)
    model = trainer.model
    calls = iter(range(100))
    real = model.loss_fn

    def drifting(ex, generator=None, training=True):
        loss, aux = real(ex, generator, training)
        return loss + 1e-3 * next(calls), aux

    with mock.patch.object(model, 'loss_fn', drifting), \
            pytest.raises(AssertionError, match='non-replicating loss'):
        trainer.test_run(data, model.prepare_validate_dataset(
            prefetch=False))


def test_checkpoint_retention(tmp_path):
    trainer, data = _trainer(tmp_path, stop=5, checkpoint=1)
    trainer.max_checkpoints = 2
    trainer.train(data)
    ckpt_dir = trainer.checkpoint_dir
    numbered = {p.name for p in ckpt_dir.glob('ckpt_*.npz')
                if p.stem.split('_')[-1].isdigit()}
    latest = (ckpt_dir / 'ckpt_latest.npz').resolve().name
    best = (ckpt_dir / 'ckpt_best_loss.npz').resolve().name
    assert latest == 'ckpt_5.npz'
    assert numbered == {'ckpt_4.npz', 'ckpt_5.npz', best}


def test_early_stop_patience(tmp_path, monkeypatch):
    trainer, data = _trainer(tmp_path, stop=10, checkpoint=1,
                             early_stop_patience=2)
    losses = iter([1.0, 0.5, 0.6, 0.7, 0.8, 0.9])
    monkeypatch.setattr(Trainer, 'validate',
                        lambda self: (next(losses), ReviewSummary()))
    assert trainer.train(data) == 4
    assert (trainer.checkpoint_dir / 'ckpt_best_loss.npz').resolve().name \
        == 'ckpt_2.npz'


def test_async_checkpoints_and_resume(tmp_path):
    trainer, data = _trainer(tmp_path, stop=2, async_checkpoints=True)
    assert trainer.async_checkpoints
    trainer.train(data)
    assert (trainer.checkpoint_dir / 'ckpt_latest.npz').exists()
    again, data = _trainer(tmp_path, stop=3, async_checkpoints=True)
    assert again.train(data, resume=True) == 3


def test_mesh_is_not_ported(tmp_path):
    """The data axis is ported (tests/test_torch_port_multihost.py); the
    model axis is item 4b and raises; a data axis of 2 needs 2 processes."""
    with pytest.raises(NotImplementedError, match='Queue 1 item 4b'):
        _port_eg('tsvad', tmp_path, mesh={'data': 2, 'model': 2})
    eg = _port_eg('tsvad', tmp_path, mesh={'data': 2})
    with pytest.raises(ValueError, match='start 2 processes'):
        eg.trainer.ensure_init()


def test_reports(tmp_path):
    trainer, data = _trainer(tmp_path, stop=2)
    model = trainer.model
    trainer.ensure_init()
    ex = next(iter(data))
    table = track.param_table(model)
    assert f'{model.num_params():>12,}' in table.splitlines()[-1]
    shapes = track.shape_report(model, ex)
    assert 'post_net.birnn2' in shapes and '(1, 1, 6, 8)' in shapes
    times = track.layer_time_report(model, ex, iters=1)
    assert times.splitlines()[-1].startswith('total')
    assert 'operations' in track.cost_report(model, ex)


# -- the CLI -------------------------------------------------------------------

def test_cli_flags():
    command, files, overrides = run.parse_argv(
        ['train', 'with', 'cfg.yaml', 'a.b=1', '--pdb', '--cpu'])
    assert (command, files, overrides) == ('train', ['cfg.yaml'], {'a.b': 1})
    with pytest.raises(ValueError, match='Unknown flag'):
        run.parse_argv(['train', 'with', 'cfg.yaml', '--gpu'])


def test_runtime_options(monkeypatch):
    env = {'TSSEP_COMPUTE_DTYPE': 'bfloat16', 'TSSEP_PALLAS_CONDFUSE': '1',
           'TSSEP_PALLAS_FULLFUSE': '0', 'TSSEP_PALLAS_BIDI': '0'}
    assert run.runtime_options(['--cpu'], env) == {
        'device': torch.device('cpu'), 'storage_dtype': torch.bfloat16,
        'head_dtype': F32, 'cond_fuse': True, 'fullfuse': False,
        'spill': False, 'bidi': False}
    assert run.runtime_options(['--cpu'], dict(env, TSSEP_HEAD_BF16='1'))[
        'head_dtype'] == torch.bfloat16
    assert run.runtime_options(['--cpu'], {})['storage_dtype'] == F32
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='--cpu'):
        run.runtime_options([], {})


def _reduced_yaml(tmp_path, extra=()):
    cfg = reduce_parameters(_load_reduced('init_cfg_tsvad.yaml', 'x'),
                            *extra)
    cfg['eg']['trainer'].pop('storage_dir')
    dump_yaml(cfg, tmp_path / 'reduced.yaml')
    return tmp_path / 'reduced.yaml'


def test_cli_init_writes_the_storage_dir(tmp_path):
    storage = tmp_path / 'eg'
    eg = run.main(['init', 'with', str(_reduced_yaml(tmp_path)),
                   f'eg.trainer.storage_dir={storage}',
                   'eg.trainer.stop_trigger=[3,iteration]', '--cpu'])
    assert eg.trainer.stop_trigger == 3
    assert eg.trainer.model.device == torch.device('cpu')
    config = run.load_yaml(storage / 'config.yaml')
    assert config['eg']['trainer']['factory'] == \
        'tssep_tpu_torch.train.trainer.Trainer'
    assert config['eg']['trainer']['stop_trigger'] == [3, 'iteration']
    assert 'python -m tssep_tpu_torch.train.run' in (
        storage / 'Makefile').read_text()
    assert (storage / 'python_history.txt').exists()
    info = json.loads((storage / 'host_info.json').read_text())
    assert info['torch'] == torch.__version__
    assert (storage / 'log' / 'model.txt').exists()


# -- slow: the A/B against JAX, the CLI and the launchers -----------------

@pytest.mark.slow
def test_tsvad_training_matches_jax(tmp_path):
    """The reduced TS-VAD stage, float32, without the random speaker order
    (JAX's key draws cannot be reproduced), from the same initial
    parameters: the port's and JAX's ``Experiment.train`` agree in every
    iteration's loss, every validation and the final parameters."""
    extra = {'stop_trigger': [4, 'iteration'],
             'checkpoint_trigger': [2, 'iteration'],
             'summary_trigger': [1, 'iteration']}
    jeg = _jax_eg('tsvad', tmp_path / 'jax', **extra)
    peg = _port_eg('tsvad', tmp_path / 'port', **extra)
    for eg in (jeg, peg):
        eg.trainer.model.mask_estimator.random_speaker_order = False
    jeg.trainer.ensure_init()
    path = jax_ckpt.save_checkpoint(tmp_path / 'init', 0, jeg.trainer.params)
    jeg.init_ckpt = jax_init.InitCheckPoint(init_ckpt=str(path))
    peg.init_ckpt = init_ckpt.InitCheckPoint(init_ckpt=str(path))
    assert jeg.train() == peg.train() == 4
    for key in ('train/loss', 'validation/mean_loss'):
        got, want = _losses(tmp_path / 'port', key), _losses(
            tmp_path / 'jax', key)
        assert len(got) == len(want) > 0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    got, _, _ = ckpt_lib.load_checkpoint(
        tmp_path / 'port' / 'checkpoints' / 'ckpt_latest.npz')
    want, _, _ = jax_ckpt.load_checkpoint(
        tmp_path / 'jax' / 'checkpoints' / 'ckpt_latest.npz')
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    with np.load(path) as init:     # training moved the weights
        assert not np.array_equal(
            got['mask_estimator.post_net.linear2.weight'],
            init['model/mask_estimator.post_net.linear2.weight'])


def _cli_env():
    env = dict(os.environ)
    env['PYTHONPATH'] = str(REPO) + os.pathsep + env.get('PYTHONPATH', '')
    return env


@pytest.mark.slow
def test_two_stage_recipe_through_the_cli_and_launchers(tmp_path):
    """TS-VAD, then TS-SEP warm-started from its best checkpoint, each a
    subprocess of ``python -m tssep_tpu_torch.train.run`` started by the
    port's launchers on the CPU; the second TS-VAD call resumes and stops
    at once."""
    from tssep_tpu_torch.exp import run_tssep, run_tsvad
    common = _reduced_yaml(tmp_path)
    env = _cli_env()

    def patched_run(cmd, failure='raise', cwd=None):
        result = subprocess.run(cmd, cwd=cwd, env=env)
        assert result.returncode == 0, (cmd, result.returncode)

    vad = tmp_path / 'tsvad'
    exp = REPO / 'tssep_tpu_torch' / 'exp'
    with mock.patch.object(run_tsvad, 'run', patched_run):
        run_tsvad.main(configs=[common, exp / 'init_cfg_tsvad.yaml'],
                       storage_dir=vad, flags=('--cpu',))
        run_tsvad.main(configs=[common, exp / 'init_cfg_tsvad.yaml'],
                       storage_dir=vad, flags=('--cpu',))
    best = vad / 'checkpoints' / 'ckpt_best_loss.npz'
    for name in ('config.yaml', 'Makefile', 'python_history.txt',
                 'metrics.jsonl', 'checkpoints/ckpt_latest.npz'):
        assert (vad / name).exists(), name
    assert len(_losses(vad)) == 2       # the second call trained no more
    with mock.patch.object(run_tssep, 'run', patched_run):
        run_tssep.main(configs=[common, exp / 'init_cfg_tssep.yaml'],
                       storage_dir=tmp_path / 'tssep', checkpoint=best,
                       flags=('--cpu',))
    config = run.load_yaml(tmp_path / 'tssep' / 'config.yaml')
    assert config['eg']['init_ckpt']['init_ckpt'] == str(best.resolve())
    assert (tmp_path / 'tssep' / 'checkpoints' / 'ckpt_latest.npz').exists()


@pytest.mark.slow
def test_cli_without_cuda_and_without_cpu_flag_raises(tmp_path):
    code = ('import torch; torch.cuda.is_available = lambda: False\n'
            'from tssep_tpu_torch.train.run import main\n'
            f'main(["init", "with", {str(_reduced_yaml(tmp_path))!r}, '
            f'"eg.trainer.storage_dir={tmp_path / "eg"}"])')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, env=_cli_env(), timeout=300)
    assert proc.returncode != 0
    assert 'pass --cpu' in proc.stderr
