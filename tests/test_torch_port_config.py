"""The port's configuration system against ``tssep_tpu``'s.

``tssep_tpu_torch/config/configurable.py`` against
``tssep_tpu/config/configurable.py``: the dogmatic layering cases of
``tests/test_config.py`` run against both packages; both recipe stages'
layered YAMLs resolve (``Experiment.get_config``) to JAX's configuration
with every factory ``tssep_tpu.`` -> ``tssep_tpu_torch.``; the port builds
from a ``config.yaml`` dumped by the JAX package without importing it; the
reference's factory aliases resolve to the port's classes; port-only
arguments never enter a configuration.
"""

import subprocess
import sys
import textwrap
import unittest.mock as mock
from pathlib import Path

import pytest
import torch
import yaml

from tssep_tpu.compat import aliases as jax_aliases
from tssep_tpu.config import configurable as jax_cfg
from tssep_tpu.train.experiment import Experiment as JaxExperiment
from tssep_tpu_torch.config import configurable as port_cfg
from tssep_tpu_torch.nn.estimator import MaskEstimator
from tssep_tpu_torch.tasks.model import Model
from tssep_tpu_torch.train.experiment import Experiment

REPO = Path(__file__).resolve().parents[1]
JAX_EXP = REPO / 'tssep_tpu' / 'exp'
PORT_EXP = REPO / 'tssep_tpu_torch' / 'exp'
PACKAGES = {'jax': jax_cfg, 'port': port_cfg}


def mapped(obj):
    """``obj`` with every ``tssep_tpu.`` string read as
    ``tssep_tpu_torch.`` and tuples as lists (as YAML holds them)."""
    if isinstance(obj, dict):
        return {k: mapped(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [mapped(v) for v in obj]
    if isinstance(obj, str) and obj.startswith('tssep_tpu.'):
        return 'tssep_tpu_torch.' + obj[len('tssep_tpu.'):]
    return obj


def stage_config(stage, exp=JAX_EXP, load=jax_cfg.load_yaml,
                 merge=jax_cfg.nested_merge):
    cfg = merge(load(exp / 'init_cfg_common.yaml'),
                load(exp / f'init_cfg_{stage}.yaml'))
    cfg['eg']['trainer']['storage_dir'] = '/nonexistent/storage'
    return cfg


# -- the dogmatic layering of tests/test_config.py, in both packages --------

def _classes(cfg, tag):
    """The classes of ``tests/test_config.py`` on ``cfg``'s
    ``Configurable``, module-level (factories are written as import
    paths)."""
    class Leaf(cfg.Configurable):
        def __init__(self, a=1, b='x'):
            self.a, self.b = a, b

    class Leaf2(cfg.Configurable):
        def __init__(self, c=5):
            self.c = c

    class Parent(cfg.Configurable):
        @classmethod
        def finalize_dogmatic_config(cls, config):
            config['child'] = {'factory': Leaf, 'a': 10}
            config['derived'] = config['child'].get('a', 0) * 2

        def __init__(self, child, derived=0, name='p'):
            self.child, self.derived, self.name = child, derived, name

    for cls in (Parent, Leaf, Leaf2):
        cls.__qualname__ = cls.__name__ = f'{cls.__name__}_{tag}'
        globals()[cls.__name__] = cls
    return Parent, Leaf, Leaf2


CLASSES = {name: _classes(cfg, name) for name, cfg in PACKAGES.items()}


def _strip(cfg):
    """A config without its factories (each package has its classes)."""
    if isinstance(cfg, dict):
        return {k: _strip(v) for k, v in cfg.items() if k != 'factory'}
    return cfg


@pytest.mark.parametrize('updates', [
    None, {'child': {'a': 3}, 'name': 'q'}, {'child': {'factory': 'Leaf2'}}],
    ids=['defaults', 'user wins', 'factory swap'])
def test_dogmatic_layering_as_jax(updates):
    out = {}
    for name, cfg in PACKAGES.items():
        Parent, Leaf, Leaf2 = CLASSES[name]
        upd = None if updates is None else {
            k: ({'factory': Leaf2} if v == {'factory': 'Leaf2'} else v)
            for k, v in updates.items()}
        config = Parent.get_config(upd)
        out[name] = _strip(config)
        swapped = bool(updates) and 'factory' in updates.get('child', {})
        assert isinstance(cfg.from_config(config).child,
                          Leaf2 if swapped else Leaf)
    assert out['port'] == out['jax']


def test_nested_helpers_as_jax():
    a = {'x': {'y': 1, 'z': 2, 'f': {'factory': 'a.A', 'k': 1}}, 'w': 3}
    b = {'x': {'y': 10, 'f': {'factory': 'b.B', 'j': 2}}}
    assert port_cfg.nested_merge(a, b) == jax_cfg.nested_merge(a, b)
    assert a['x']['y'] == 1
    for cfg in PACKAGES.values():
        d = {}
        cfg.nested_set(d, 'a.b.c', 1)
        view = cfg.NestedView(d)
        assert view['a.b.c'] == 1 and 'a.b' in view and 'a.x' not in view
        assert cfg.nested_get(d, 'a.q', None) is None


# -- the recipe's stages -----------------------------------------------------

@pytest.mark.parametrize('stage', ['tsvad', 'tssep'])
def test_stage_config_equals_jax(stage):
    want = mapped(JaxExperiment.get_config(stage_config(stage)['eg']))
    assert mapped(Experiment.get_config(stage_config(stage)['eg'])) == want
    # the port's own YAMLs (tssep_tpu_torch/exp) resolve to the same
    ours = stage_config(stage, PORT_EXP, port_cfg.load_yaml,
                        port_cfg.nested_merge)
    assert Experiment.get_config(ours['eg']) == want


@pytest.mark.parametrize('name', ['init_cfg_common.yaml', 'init_cfg_tsvad.yaml',
                                  'init_cfg_tssep.yaml'])
def test_port_yamls_are_the_jax_yamls(name):
    assert port_cfg.load_yaml(PORT_EXP / name) == mapped(
        jax_cfg.load_yaml(JAX_EXP / name))


def test_yaml_dump_round_trip_as_jax():
    jax_config = JaxExperiment.get_config(stage_config('tssep')['eg'])
    port_config = Experiment.get_config(stage_config('tssep')['eg'])
    assert yaml.safe_load(port_cfg.dumps_yaml(port_config)) == mapped(
        yaml.safe_load(jax_cfg.dumps_yaml(jax_config)))
    assert port_cfg.dumps_yaml(port_config) == port_cfg.dumps_yaml(
        mapped(jax_config))


@pytest.mark.slow
def test_port_builds_from_a_jax_dumped_config(tmp_path):
    """A ``config.yaml`` dumped by the JAX package (reduced widths) builds
    the port's Experiment in a process where neither JAX nor
    ``tssep_tpu`` is imported."""
    cfg = stage_config('tsvad')
    me = cfg['eg']['trainer']['model']['mask_estimator']
    me.update(units=4, projs=5)
    cfg['eg']['trainer']['storage_dir'] = str(tmp_path / 'eg')
    jax_cfg.dump_yaml({'eg': JaxExperiment.get_config(cfg['eg'])},
                      tmp_path / 'config.yaml')
    code = textwrap.dedent(f'''
        import sys, torch
        from tssep_tpu_torch.config.configurable import from_config, load_yaml
        eg = from_config(load_yaml({str(tmp_path / 'config.yaml')!r})['eg'],
                         device='cpu', storage_dtype=torch.float32)
        me = eg.trainer.model.mask_estimator
        assert type(eg).__module__ == 'tssep_tpu_torch.train.experiment'
        assert (me.units, me.projs, me.idim, me.ts_vad) == (4, 5, 553, 8)
        assert eg.trainer.model.loss.name == 'VADSigmoidBCE'
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'tssep_tpu'))
        assert not bad, bad
        print('ok')
    ''')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


# -- factories ---------------------------------------------------------------

@pytest.mark.parametrize('alias', sorted(jax_aliases._ALIASES))
def test_reference_alias_resolves_in_the_port(alias):
    """Each alias of the reference's factory paths resolves to the port's
    class of the JAX target's name, the Kaldi features' too."""
    target = jax_aliases._ALIASES[alias]
    cls = port_cfg.import_class(alias)
    assert cls.__module__ == mapped(target).rpartition('.')[0]
    assert cls.__name__ == target.rpartition('.')[2]


@pytest.mark.parametrize('path', [
    'tssep_tpu.data.simulate.MeetingSimulator',
    'tssep_tpu.data.shard_corpus.ShardCorpusReader',
    'tssep_tpu.data.import_corpus.import_corpus',
    'tssep_tpu.eval.ctc.CTCRecognizer',
    'tssep_tpu.exp.run_simulated.main',
    'tssep_tpu.eval.streaming.StreamingSession',
    'tssep_tpu.features.kaldi.KaldiMFCC'])
def test_simulated_recipe_modules_resolve(path):
    """The simulated-corpus recipe's modules resolve in the port, streaming
    and the Kaldi features too, and so do the distributed modules (item
    4): no module of the JAX package is left unported."""
    found = port_cfg.import_class(path)
    assert found.__module__ == mapped(path).rpartition('.')[0]
    assert found.__name__ == path.rpartition('.')[2]
    assert port_cfg.import_class('tssep_tpu.dist.mesh.make_mesh') \
        .__module__ == 'tssep_tpu_torch.dist.mesh'
    assert port_cfg.NOT_PORTED == {}


def test_port_builds_from_a_jax_simulated_stage_config(tmp_path):
    """A ``config.yaml`` that JAX's ``run_simulated._dump_stage_config``
    wrote for the TS-SEP stage (shard reader, explicit VAD, the joint
    loss, the warm start) builds the port's Experiment."""
    from tssep_tpu.exp import run_simulated as jax_recipe
    shards = {split: str(tmp_path / f'{split}.shard')
              for split in ('train', 'validate', 'eval')}
    cfg = jax_recipe._config(tmp_path, shards, 'tssep', 8, 2, aux_size=513,
                             checkpoint=tmp_path / 'ckpt.npz',
                             explicit_vad=True, vad_weight=0.3)
    jax_recipe._dump_stage_config(tmp_path / 'tssep',
                                  JaxExperiment.get_config(cfg))
    config = port_cfg.load_yaml(tmp_path / 'tssep' / 'config.yaml')
    eg = port_cfg.from_config(config['eg'], device='cpu',
                              storage_dtype=torch.float32)
    model = eg.trainer.model
    assert type(model.reader).__module__ == \
        'tssep_tpu_torch.data.shard_corpus'
    assert model.reader.eval_shard == shards['eval']
    assert model.loss.name == 'SignalAndVADSigmoidBCE'
    assert model.mask_estimator.explicit_vad
    assert (model.mask_estimator.units, model.mask_estimator.projs) == (64, 64)
    assert type(eg.init_ckpt).__name__ == 'InitCheckPointVAD2Sep'


def test_import_class_rules():
    assert port_cfg.import_class(Model) is Model
    assert port_cfg.import_class('tssep_tpu.tasks.model.Model') is Model
    assert port_cfg.import_class('tssep_tpu_torch.tasks.model.Model') is Model
    assert port_cfg.import_class('MaskEstimator') is MaskEstimator
    assert port_cfg.import_class(
        'tssep.train.net.MaskEstimator_v2') is MaskEstimator
    # a module not ported yet raises naming its queue item
    with mock.patch.dict(port_cfg.NOT_PORTED,
                         {'tssep_tpu_torch.dist.': 'ROADMAP Queue 1 item 4b'}):
        with pytest.raises(NotImplementedError, match='Queue 1 item 4b'):
            port_cfg.import_class('tssep_tpu.dist.mesh.make_mesh')
    assert port_cfg.import_class('tssep_tpu.dist.multihost.initialize') \
        .__module__ == 'tssep_tpu_torch.dist.multihost'
    with pytest.raises(ImportError):
        port_cfg.import_class('NoSuchFactory')
    assert 'tssep_tpu' not in {m.split('.')[0] for m in
                               port_cfg.FACTORY_ALIASES.values()}


def test_port_only_arguments_stay_out_of_configs():
    cfg = port_cfg.get_config(MaskEstimator, {'idim': 9, 'odim': 9,
                                              'units': 4, 'projs': 5})
    assert not port_cfg.PORT_ONLY & set(cfg)
    me = port_cfg.from_config(cfg, device='cpu',
                              storage_dtype=torch.float32, spill=True)
    assert me.storage_dtype == torch.float32
    assert me.pre_net.spill
    with pytest.raises(TypeError, match='not port-only'):
        port_cfg.from_config(cfg, units=3)
