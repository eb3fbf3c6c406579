"""The port's simulated-corpus recipe (``exp/run_simulated.py``) against
``tssep_tpu``'s: both stages' configurations resolve to JAX's with the
factories read as the port's, the command line's keywords, and the
launcher's device rule. Slow tier: the port's recipe end to end on the CPU
at the size of ``tests/test_simulate.py:74-100`` (6 channels, reverb taps
2, a word vocabulary and its CTC recognizer), with that test's assertions,
then ``joint_eval`` on its two stages."""

import numpy as np
import pytest
import torch

from tssep_tpu.exp import run_simulated as jax_recipe
from tssep_tpu.train.experiment import Experiment as JaxExperiment
from tssep_tpu_torch.exp import run_simulated
from tssep_tpu_torch.train.experiment import Experiment

from test_torch_port_config import mapped


@pytest.mark.parametrize('stage,explicit_vad', [
    ('tsvad', False), ('tssep', True), ('tssep', False)])
def test_stage_configs_resolve_to_jax(tmp_path, stage, explicit_vad):
    shards = {split: tmp_path / f'{split}.shard'
              for split in ('train', 'validate', 'eval')}
    args = (tmp_path, shards, stage, 160, 8)
    kwargs = dict(aux_size=513, checkpoint=tmp_path / 'ckpt.npz',
                  explicit_vad=explicit_vad, vad_weight=0.3)
    ours = run_simulated._config(*args, **kwargs)
    theirs = jax_recipe._config(*args, **kwargs)
    assert ours == mapped(theirs)
    assert mapped(Experiment.get_config(ours)) == mapped(
        JaxExperiment.get_config(theirs))


def test_command_line():
    args, kw, multichannel = run_simulated._cli(
        ['build/w', '--multichannel', '--vocabulary=8', '--vad_weight=0.5',
         '--work=x', '--cpu'])
    assert args == ['build/w'] and multichannel
    assert kw == {'vocabulary': 8, 'vad_weight': 0.5, 'work': 'x',
                  'device': 'cpu'}
    assert run_simulated._cli(['--tsvad_iters=40']) == (
        [], {'tsvad_iters': 40}, False)


def test_recipe_needs_cuda_or_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='--cpu'):
        run_simulated.main(tmp_path / 'w')
    assert not (tmp_path / 'w').exists()


@pytest.mark.slow
def test_multichannel_recipe_end_to_end(tmp_path, monkeypatch):
    """``main_multichannel`` at CI scale on the CPU in float32, with the
    assertions of the JAX package's test; the word corpus adds the CTC
    recognizer and cpWER. Then ``joint_eval`` of its stages."""
    monkeypatch.setenv('TSSEP_COMPUTE_DTYPE', 'float32')
    out = run_simulated.main_multichannel(
        tmp_path / 'mc', train_examples=4, eval_examples=2, tsvad_iters=6,
        tssep_iters=6, batch=2, aux_size=513, duration=2.0,
        strict_comparison=False, vocabulary=8, ctc_steps=4, device='cpu')
    vad_m, sep_m, bf_m = out
    assert vad_m['summary']['num_recordings'] == 2
    assert bf_m['summary']['num_recordings'] == 2
    if bf_m['summary'].get('degenerate'):
        assert bf_m['summary']['degenerate_reasons']
    else:
        assert 'mean_si_sdr' in bf_m['summary']
        assert np.isfinite(bf_m['summary']['mean_si_sdr'])
    assert all('num_segments' in r for r in bf_m['per_recording'])
    assert 'mean_cp_wer' in sep_m['summary']
    for split in ('train', 'validate', 'eval'):
        assert (tmp_path / 'mc' / f'{split}.shard').exists()
    assert (tmp_path / 'mc' / 'ctc_asr.npz').exists()
    for stage in ('tsvad', 'tssep'):
        text = (tmp_path / 'mc' / stage / 'config.yaml').read_text()
        assert 'tssep_tpu_torch.data.shard_corpus.ShardCorpusReader' in text

    from tssep_tpu_torch.config.configurable import from_config, load_yaml
    egs = [from_config(load_yaml(tmp_path / 'mc' / stage / 'config.yaml')
                       ['eg'], device='cpu', storage_dtype=torch.float32)
           for stage in ('tsvad', 'tssep')]
    summary = run_simulated.joint_eval(*egs, limit=1)
    assert 'der' in summary
