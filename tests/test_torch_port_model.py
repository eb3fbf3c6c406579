"""The port's modules and its serving forward against ``tssep_tpu`` on the CPU.

Inputs are made with numpy from a seed and handed to both packages; weights
are the JAX package's, carried across by name (``compat/from_jax.py``).
Tolerances: 1e-4 for the modules and the slice, as in
``tests/test_torch_parity.py`` (float32 throughout; the two packages sum in
other orders, through up to four recurrent layers); the STFT is compared at
1e-5 of the spectrum's scale (one FFT against a float32 DFT product).
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tssep_tpu.features import extractor as jax_fe
from tssep_tpu.nn.rnnp import RNNP as JaxRNNP
from tssep_tpu.signal.stft import STFT as JaxSTFT
from tssep_tpu.tasks.model import Model as JaxModel
from tssep_tpu.train.checkpoint import params_to_named, save_checkpoint
from tssep_tpu_torch.compat.from_jax import load_named, load_npz
from tssep_tpu_torch.features.extractor import Log1pMaxNormAbsSTFT
from tssep_tpu_torch.nn.rnnp import RNNP
from tssep_tpu_torch.signal.stft import STFT
from tssep_tpu_torch.tasks.model import Model
from tssep_tpu_torch.train.trainer import Trainer
from tssep_tpu_torch.utils.device import resolve_device

ATOL = 1e-4
F32 = torch.float32

FLAGSHIP = {
    'fe': {'size': 1024, 'shift': 256, 'window': 'hann'},
    'reader': {'aux_size': 513},
    'mask_estimator': {
        'units': 300, 'projs': 320, 'combination': 'mul', 'ts_vad': 8,
        'aux_net_output_size': 513, 'num_averaged_permutations': 1,
        'output_resolution': 'tf',
    },
}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


# -- signal and features -----------------------------------------------------

@pytest.mark.parametrize('window,samples', [('hann', 1000), ('blackman', 777)])
def test_stft_and_istft_match_jax(window, samples):
    sig = np.random.default_rng(0).standard_normal((2, 1, samples)).astype(
        np.float32)
    ours, ref = (STFT(size=64, shift=16, window=window),
                 JaxSTFT(size=64, shift=16, window=window))
    spec = ours.stft(torch.from_numpy(sig))
    ref_spec = np.asarray(ref.stft(jnp.asarray(sig)))
    assert spec.shape == ref_spec.shape
    scale = np.abs(ref_spec).max()
    _close(spec.numpy() / scale, ref_spec / scale, atol=1e-5)
    wave = ours.istft(spec, num_samples=samples)
    _close(wave, ref.istft(jnp.asarray(ref_spec), num_samples=samples),
           atol=1e-5)
    _close(wave, sig, atol=1e-5)                  # exact reconstruction


def test_stft_frame_count_golden():
    """10_000 samples, size 1024, shift 256, fading -> 43 frames."""
    stft = STFT(size=1024, shift=256)
    assert stft.num_frames(10_000) == 43
    assert stft.stft(torch.zeros(10_000)).shape == (43, 513)


@pytest.mark.parametrize('axis', ['tf', 't', 'f'])
def test_log1p_max_norm_feature_matches_jax(axis):
    sig = np.random.default_rng(1).uniform(-1, 1, (2, 900)).astype(np.float32)
    ours = Log1pMaxNormAbsSTFT(size=64, shift=16, window='hann',
                               statistics_axis=axis)
    ref = jax_fe.Log1pMaxNormAbsSTFT(size=64, shift=16, window='hann',
                                     statistics_axis=axis)
    _close(ours(torch.from_numpy(sig)), ref(jnp.asarray(sig)), atol=1e-5)


# -- network -----------------------------------------------------------------

@pytest.mark.parametrize('idim,elayers,lead', [
    (12, 2, (3,)),          # fully fused kernel's plain version
    (12, 1, (2, 3)),        # rank 4: speakers folded into the batch
    (2049, 1, (2,)),        # wider than FULLFUSE_MAX_INPUT: bidi kernel
])
def test_rnnp_matches_jax(idim, elayers, lead):
    jr = JaxRNNP(idim=idim, elayers=elayers, cdim=16, hdim=10)
    params = jr.init(jax.random.PRNGKey(0))
    ours = RNNP(idim, elayers=elayers, cdim=16, hdim=10, storage_dtype=F32,
                device='cpu')
    load_named(ours, params_to_named(params))
    x = np.random.default_rng(2).standard_normal(lead + (9, idim)).astype(
        np.float32)
    _close(ours(torch.from_numpy(x)).detach(), jr.apply(params, jnp.asarray(x)))


# -- the slice ---------------------------------------------------------------

def _small_config(combination, ts_vad, explicit_vad, projs=12):
    return {
        'fe': {'size': 64, 'shift': 16, 'window': 'hann'},
        'mask_estimator': {
            'units': 16, 'projs': projs, 'combination': combination,
            'ts_vad': ts_vad,
            'aux_net_output_size': 33 if combination == 'mul' else 20,
            'output_resolution': 'tf', 'explicit_vad': explicit_vad,
        },
    }


def _request(B, S, A, samples=1200, seed=3):
    rng = np.random.default_rng(seed)
    return {'observation': rng.standard_normal((B, 1, samples)).astype(
                np.float32),
            'auxInput': rng.uniform(0, 1, (B, S, A)).astype(np.float32),
            'reference_channel': 0}


def _both(cfg):
    jm = JaxModel.new(cfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    ours = Model.from_config(cfg, storage_dtype=F32, device='cpu')
    load_named(ours, params_to_named(params))
    return jm, params, ours


@pytest.mark.parametrize('combination,ts_vad,explicit_vad,projs', [
    ('mul', 3, False, 12),
    ('cat', 4, True, 12),
    ('mul', 4, False, 520),     # stacked width 2080: the bidi kernel's arm
])
def test_forward_matches_jax(combination, ts_vad, explicit_vad, projs):
    cfg = _small_config(combination, ts_vad, explicit_vad, projs)
    jm, params, ours = _both(cfg)
    ex = _request(2, ts_vad, cfg['mask_estimator']['aux_net_output_size'])
    ref = jm.forward(params, {k: jnp.asarray(v) for k, v in ex.items()},
                     rng=None)
    ref_wave = jm.fe.istft(ref.stft_estimate,
                           num_samples=ex['observation'].shape[-1])
    out = ours(ex)
    assert out.mask.shape == ref.mask.shape
    _close(out.mask, ref.mask)
    _close(out.time_estimate, ref_wave)
    if explicit_vad:
        _close(out.vad_mask, ref.vad_mask)
    else:
        _close(out.logit, ref.logit)


def test_speaker_order_draw_is_undone():
    """Without ts_vad stacking the speakers run independently, so a random
    speaker order drawn from a generator must not change the masks."""
    _, _, ours = _both(_small_config('mul', False, False))
    ex = _request(2, 3, 33)
    plain = ours(ex)
    drawn = ours(ex, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(drawn.mask, plain.mask, atol=1e-6, rtol=0)


def test_flagship_parameter_count_matches_jax():
    ours = Model.from_config(FLAGSHIP, storage_dtype=F32, device='cpu')
    assert ours.num_params() == JaxModel.new(FLAGSHIP).num_params() \
        == 14_476_257


def test_load_npz_reads_a_jax_checkpoint(tmp_path):
    jm, params, _ = _both(_small_config('mul', 3, False))
    path = save_checkpoint(tmp_path, 7, params)
    ours = Model.from_config(_small_config('mul', 3, False),
                             storage_dtype=F32, device='cpu')
    load_named(ours, load_npz(path))
    for name, value in params_to_named(params).items():
        np.testing.assert_array_equal(
            ours.state_dict()[name].numpy(), value)


def test_not_ported_options_raise():
    """A waveform feature extractor (``features/kaldi.py``) now builds into
    a model whose estimator takes its width, as JAX's does; what stays
    unported (tensor parallelism, ROADMAP Queue 1 item 4b) raises and says
    so; multi-process sharding (item 4) is ported: in one process the host
    shard is the whole dataset."""
    cfg = _small_config('cat', 3, False)
    cfg['fe'] = {'factory': 'tssep_tpu.features.kaldi.KaldiMFCC'}
    ours = Model.from_config(cfg, device='cpu')
    ref = JaxModel.new(cfg)
    assert type(ours.fe).__name__ == type(ref.fe).__name__ == 'KaldiMFCC'
    assert ours.mask_estimator.idim == ref.mask_estimator.idim == 13
    assert len(ours.prepare_train_dataset(host_shard=True, prefetch=False)) \
        == len(ours.prepare_train_dataset(prefetch=False))
    with pytest.raises(NotImplementedError, match='Queue 1 item 4b'):
        Trainer(ours, None, mesh={'model': 2})


@pytest.mark.parametrize('kwargs,raises', [
    (dict(combination='mul', num_averaged_permutations=2), True),
    (dict(combination='mul', num_averaged_permutations=2, ts_vad=3), False),
    (dict(combination='cat'), True),
    (dict(combination='cat', aux_net_output_size=20), False),
    (dict(combination='mul'), False),
    (dict(combination='mul', aux_net_output_size=20), True),
    (dict(combination='mul', aux_net_output_size=16), False),
])
def test_estimator_arguments_checked_as_jax(kwargs, raises):
    """The port's MaskEstimator raises on exactly the arguments that the
    JAX one rejects, built directly (no config defaults)."""
    from tssep_tpu.nn.estimator import MaskEstimator as JaxEstimator
    from tssep_tpu_torch.nn.estimator import MaskEstimator
    args = dict(idim=16, odim=16, layers=1, units=8, projs=8, **kwargs)
    for build in (lambda: JaxEstimator(**args),
                  lambda: MaskEstimator(**args, storage_dtype=F32,
                                        device='cpu')):
        if raises:
            with pytest.raises((AssertionError, ValueError)):
                build()
        else:
            build()


# -- package rules -----------------------------------------------------------

def test_port_imports_no_jax():
    """Importing the port, every submodule and chip_smoke.py loads neither
    jax nor any tssep_tpu module."""
    code = textwrap.dedent('''
        import importlib, pkgutil, sys
        import tssep_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            tssep_tpu_torch.__path__, 'tssep_tpu_torch.')]
        for name in names:
            importlib.import_module(name)
        for name in ('tssep_tpu_torch.data.device_sim',
                     'tssep_tpu_torch.data.dummy',
                     'tssep_tpu_torch.data.import_corpus',
                     'tssep_tpu_torch.data.shard_corpus',
                     'tssep_tpu_torch.data.simulate',
                     'tssep_tpu_torch.eval.ctc',
                     'tssep_tpu_torch.exp.run_simulated',
                     'tssep_tpu_torch.signal.vad',
                     'tssep_tpu_torch.tasks.losses',
                     'tssep_tpu_torch.train.optimizer',
                     'tssep_tpu_torch.train.trainer'):
            assert name in names, name
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'tssep_tpu'))
        assert not bad, bad
        print('ok')
    ''')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


def test_entry_points_need_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model.from_config(_small_config('mul', 3, False))
    assert Model.from_config(_small_config('mul', 3, False),
                             device='cpu').device == torch.device('cpu')
