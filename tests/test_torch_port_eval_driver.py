"""The port's long-recording eval driver (``eval/driver.py``) against
``tssep_tpu``'s: chunk starts, stitching, diarization and threshold
calibration (exact: the same numpy code), and ``ChunkedMaskEstimator`` and
``EvalDriver.run_recording`` on the tiny model of
``tests/test_eval_driver.py:56-64``, its weights carried over by
``compat/from_jax.py``, against JAX at 1e-4 in float32 on the CPU: one
recording shorter than a chunk (the chunk becomes the recording, as for
``DummyReader``'s 5 s examples), and a chunked 7-channel one
(``chunk_frames=40, hop_frames=20, batch_chunks=3``) through the
beamformer. Slow tier: ``evaluate`` of a reduced toy experiment through both
packages, and the port's eval CLI on a ``config.yaml`` the JAX CLI dumped.
"""

import json
import sys
import unittest.mock as mock
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tssep_tpu.eval import driver as jax_driver
from tssep_tpu.tasks.model import Model as JaxModel
from tssep_tpu.train.checkpoint import params_to_named
from tssep_tpu_torch.compat.from_jax import load_named
from tssep_tpu_torch.eval import driver
from tssep_tpu_torch.tasks.model import Model

ATOL = 1e-4


# -- host-side pieces, exact ------------------------------------------------------

@pytest.mark.parametrize('n,c,h', [(100, 30, 15), (100, 30, 30), (29, 30, 15),
                                   (31, 30, 15), (3750, 316, 158)])
def test_chunk_starts_and_stitching_match_jax(n, c, h):
    c = min(c, n)
    h = min(h, c)
    starts = driver._chunk_starts(n, c, h)
    assert starts == jax_driver._chunk_starts(n, c, h)
    rng = np.random.default_rng(n)
    chunks = [rng.standard_normal((3, c, 2)).astype(np.float32)
              for _ in starts]
    got = driver.stitch_chunks(chunks, starts, n, c, h, time_axis=-2)
    np.testing.assert_array_equal(
        got, jax_driver.stitch_chunks(chunks, starts, n, c, h, time_axis=-2))


@pytest.mark.parametrize('kwargs', [
    dict(threshold=0.5, smooth_kernel=11),
    dict(threshold=0.3, smooth_kernel=5, min_frames=4),
    dict(threshold=0.6, smooth_kernel=1, merge_gap=8, min_frames=3,
         pad_frames=2)])
def test_diarization_matches_jax(kwargs):
    rng = np.random.default_rng(1)
    act = np.repeat(rng.random((4, 60)), 5, axis=-1)
    act += 0.1 * rng.standard_normal(act.shape)
    for stat in ('mean', 'q90'):
        sig = rng.random((2, 30, 7))
        np.testing.assert_array_equal(
            driver.activity_from_sig(sig, stat),
            jax_driver.activity_from_sig(sig, stat))
    got = driver.diarize_from_activity(act, **kwargs)
    want = jax_driver.diarize_from_activity(act, **kwargs)
    assert [a.normalized_intervals for a in got] == [
        a.normalized_intervals for a in want]
    assert [a.shape for a in got] == [a.shape for a in want]


def test_calibration_matches_jax():
    rng = np.random.default_rng(0)
    refs = [rng.random((3, 200)) > 0.7 for _ in range(3)]
    acts = [0.25 + 0.2 * r + 0.05 * rng.standard_normal(r.shape)
            for r in refs]
    for kwargs in (dict(smooth_kernel=1), dict(smooth_kernel=5, min_frames=2,
                                                merge_gap=3, pad_frames=1)):
        got = driver.calibration_stats(acts, refs, **kwargs)
        want = jax_driver.calibration_stats(acts, refs, **kwargs)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert driver.calibrate_threshold(acts, refs, **kwargs) == \
            jax_driver.calibrate_threshold(acts, refs, **kwargs)
    # one process: cross_host changes nothing
    assert driver.calibrate_threshold(acts, refs, cross_host=True) == \
        driver.calibrate_threshold(acts, refs, cross_host=False)


def test_cross_host_calibration_raises_across_processes():
    """Under ``torch.distributed`` with more than one process, the
    per-threshold statistics are all-reduced before the argmin (the
    group's all-reduce stands in for the other process here: it doubles
    the errors of one threshold, which the choice then avoids); with
    ``cross_host=False`` they are not. Real processes:
    ``tests/test_torch_port_multihost.py``."""
    from tssep_tpu_torch.dist import multihost
    rng = np.random.default_rng(0)
    refs = [rng.random((3, 200)) > 0.7]
    acts = [0.25 + 0.2 * r + 0.05 * rng.standard_normal(r.shape)
            for r in refs]
    alone = driver.calibrate_threshold(acts, refs)
    ths = driver.calibration_stats(acts, refs)[0]
    i = int(np.argmin(np.abs(ths - alone[0])))
    reduced = []

    def all_reduce_host(stats):
        reduced.append(stats)
        stats = np.array(stats)
        stats[0] += stats[0].max() * (np.arange(len(ths)) >= i - 1)
        return stats

    with mock.patch.object(multihost, 'process_count', lambda: 2), \
            mock.patch.object(multihost, 'all_reduce_host', all_reduce_host):
        summed = driver.calibrate_threshold(acts, refs)
        assert len(reduced) == 1 and reduced[0].shape == (2, len(ths))
        assert summed[0] < alone[0]
        assert driver.calibrate_threshold(acts, refs,
                                          cross_host=False) == alone
        assert len(reduced) == 1


def test_to_numpy_casts_bf16_on_device_and_keeps_complex():
    x = torch.linspace(0, 1, 7, dtype=torch.bfloat16)
    got = driver.to_numpy(x)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.float().numpy())
    c = torch.randn(3, dtype=torch.complex64)
    assert driver.to_numpy(c).dtype == np.complex64


# -- the driver on the tiny model, against JAX ------------------------------------

def _tiny_config(channels):
    return {
        'fe': {'size': 64, 'shift': 32, 'window_length': 64},
        'reader': {'sample_rate': 1000, 'aux_size': 33,
                   'num_channels': channels},
        'mask_estimator': {'units': 4, 'projs': 5, 'combination': 'mul',
                           'ts_vad': 8, 'aux_net_output_size': 33,
                           'num_averaged_permutations': 1,
                           'random_speaker_order': False},
    }


@pytest.fixture
def scan_unroll_1():
    """The JAX scan path with one step per scan iteration: the same
    arithmetic as its default of 8, compiled in a fraction of the time."""
    from tssep_tpu.nn import rnnp as jax_rnnp
    saved = jax_rnnp.DEFAULT_UNROLL
    jax_rnnp.DEFAULT_UNROLL = 1
    yield
    jax_rnnp.DEFAULT_UNROLL = saved


def _both(channels, seed=0):
    """The tiny model in both packages, with one set of weights drawn by
    numpy (``jax.eval_shape``: no JAX draw to compile)."""
    cfg = _tiny_config(channels)
    jm = JaxModel.new(cfg)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda leaf: rng.uniform(-1, 1, leaf.shape).astype(np.float32),
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)))
    ours = Model.from_config(cfg, storage_dtype=torch.float32, device='cpu')
    load_named(ours, params_to_named(params))
    return jm, params, ours


def _threshold_off(activity, atol, start=0.5):
    """The threshold nearest ``start`` that lies more than ``atol`` from
    every activity value. A random tiny model's activity (a frequency mean
    of sigmoids) crowds around 0.5, where float noise at ``atol`` would
    flip frames between the packages; a threshold inside a gap of the
    values keeps the diarization non-trivial and its comparison exact."""
    values = np.sort(np.asarray(activity).ravel())
    for step in range(1, 10_000):
        for th in (start + step * atol / 4, start - step * atol / 4):
            if np.abs(values - th).min() > atol:
                return float(th)
    raise AssertionError('no threshold clears the activity by the tolerance')


def _check_activity_margin(activity, threshold, atol):
    """The diarization thresholds the activity: a value within ``atol`` of
    the threshold may flip a frame between the packages, so the comparison
    of the diarizations below holds only where none does."""
    margin = float(np.abs(np.asarray(activity) - threshold).min())
    assert margin > atol, (
        f'an activity value lies {margin:.3g} from the threshold '
        f'{threshold}, within the tolerance {atol}: the diarizations '
        f'cannot be compared on this input')


@pytest.mark.parametrize('channels,chunk,hop,batch,beamform', [
    (1, 316, 158, 8, False),       # shorter than a chunk: chunk = recording
    (7, 40, 20, 3, True)])         # 7 chunks in 3 calls, the last padded
def test_run_recording_matches_jax(channels, chunk, hop, batch, beamform,
                                   scan_unroll_1):
    jm, params, ours = _both(channels)
    ex = next(iter(ours.prepare_validate_dataset(device=False,
                                                 prefetch=False)))
    obs, aux = ex['observation'], ex['auxInput']
    assert obs.shape[0] == channels
    kwargs = dict(chunk_frames=chunk, hop_frames=hop, smooth_kernel=3,
                  min_frames=1)
    jd = jax_driver.EvalDriver(jm, **kwargs)
    jd.chunked.batch_chunks = batch
    _, activity = jd.chunked(params, np.asarray(jm.fe.stft(obs)), aux)
    kwargs['vad_threshold'] = jd.vad_threshold = _threshold_off(activity,
                                                                ATOL)
    want = jd.run_recording(params, obs, aux, beamform=beamform)
    od = driver.EvalDriver(ours, **kwargs)
    od.chunked.batch_chunks = batch
    assert od.enhancer.__class__.__name__ == 'ClassicBF'
    got = od.run_recording(obs, aux, beamform=beamform)

    frames = want['masks'].shape[-2]
    assert (frames > chunk) == (chunk == 40)
    assert got['masks'].dtype == np.float32
    np.testing.assert_allclose(got['masks'], want['masks'], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got['activity'], want['activity'], atol=ATOL,
                               rtol=0)
    _check_activity_margin(want['activity'], jd.vad_threshold, ATOL)
    assert [a.normalized_intervals for a in got['dia']] == [
        a.normalized_intervals for a in want['dia']]
    assert [a.normalized_intervals for a in got['sample_dia']] == [
        a.normalized_intervals for a in want['sample_dia']]
    assert got['num_segments'] == want['num_segments'] > 0
    assert got['beamformed'] == want['beamformed'] == beamform
    peak = np.abs(want['time_estimate']).max()
    np.testing.assert_allclose(got['time_estimate'] / peak,
                               want['time_estimate'] / peak, atol=ATOL,
                               rtol=0)
    assert od.score_der(got, ex['vad']) == jd.score_der(want, ex['vad'])
    assert set(got['stage_ms']) == {'stft', 'features', 'forward', 'stitch',
                                    'diarization', 'enhancer', 'istft'}

    # the chunked estimator alone, and through the diarization source
    masks, activity = od.chunked(od.stft(obs), aux)
    np.testing.assert_array_equal(masks, got['masks'])
    np.testing.assert_array_equal(od.activity(od.stft(obs), aux), activity)


def test_mesh_is_not_ported():
    """A data axis is ported (the chunks dealt over the ranks,
    ``tests/test_torch_port_multihost.py``: ``batch_chunks`` rounded to it);
    a model axis is item 4b."""
    from tssep_tpu_torch.dist import mesh as mesh_lib
    _, _, ours = _both(1)
    with pytest.raises(NotImplementedError, match='Queue 1 item 4b'):
        driver.ChunkedMaskEstimator(ours,
                                    mesh=mesh_lib.make_mesh(4, 2, rank=0))
    for data, want in ((2, 8), (3, 6), (16, 16)):
        chunked = driver.ChunkedMaskEstimator(
            ours, mesh=mesh_lib.make_mesh(data, rank=0))
        assert chunked.batch_chunks == want


# -- slow: evaluate and the CLI through both packages -----------------------------

sys.path.insert(0, str(Path(__file__).parent))


def _reduced_sep(storage_dir):
    """The reduced toy TS-SEP stage (``tests/test_exp.py``'s sizes) with
    the input speaker order: the JAX driver draws a random speaker order
    from a fixed key at eval, which torch cannot reproduce, and the port's
    driver keeps the input's order."""
    from test_exp import _load_reduced
    cfg = _load_reduced('init_cfg_tssep.yaml', storage_dir)
    cfg['eg']['init_ckpt'] = {
        'factory': 'tssep_tpu.train.init_ckpt.InitCheckPoint'}
    me = cfg['eg']['trainer']['model']['mask_estimator']
    me['random_speaker_order'] = False
    cfg['eg']['trainer']['model']['reader']['validate_examples'] = 2
    return cfg


#: The reduced stage has 9 frames a recording: no smoothing, 1-frame
#: segments.
_SHORT = {'smooth_kernel': 1, 'min_frames': 1}


def _save_confident(jax_trainer):
    """Save the JAX trainer's initial weights with the head's bias raised
    by 5: an untrained model's activity sits near 0.5, below the reference
    activity's calibration optimum, so every estimate would be gated to
    silence and no SI-SDR would be finite; with the bias raised, every
    speaker is active and separated streams carry signal."""
    params = jax_trainer.params
    head = params['mask_estimator']['post_net']['linear2']
    head['bias'] = head['bias'] + 5.0
    jax_trainer.params = params
    jax_trainer.save(best=True)


def _summary_close(got, want):
    for key in ('mean_der', 'mean_si_sdr'):
        assert abs(got['summary'][key] - want['summary'][key]) <= ATOL, key
    assert got['calibration'] == want['calibration']
    assert 'error' not in got['calibration']
    assert np.isfinite(got['summary']['mean_si_sdr'])
    assert [r['num_segments'] for r in got['per_recording']] == [
        r['num_segments'] for r in want['per_recording']]


@pytest.mark.slow
def test_evaluate_matches_jax(tmp_path):
    """``evaluate`` of a reduced TS-SEP experiment through both packages on
    one checkpoint the JAX trainer wrote: metrics.json's DER and SI-SDR
    within 1e-4, the same calibration and segments."""
    from tssep_tpu.config.configurable import from_config as jax_from_config
    from tssep_tpu.eval.run import evaluate as jax_evaluate
    from tssep_tpu.train.experiment import Experiment as JaxExperiment
    from tssep_tpu_torch.config.configurable import from_config
    from tssep_tpu_torch.eval.run import evaluate
    from tssep_tpu_torch.train.experiment import Experiment
    cfg = _reduced_sep(tmp_path / 'sep')
    jeg = jax_from_config(JaxExperiment.get_config(cfg['eg']))
    jeg.trainer.ensure_init()
    _save_confident(jeg.trainer)
    want = jax_evaluate(jeg, out=tmp_path / 'jax', driver_overrides=_SHORT)
    eg = from_config(Experiment.get_config(cfg['eg']), device='cpu',
                     storage_dtype=torch.float32)
    got = evaluate(eg, out=tmp_path / 'port', driver_overrides=_SHORT)
    _summary_close(got, want)
    assert got['wav_writer'] == 'native'
    assert len(list((tmp_path / 'port' / 'audio').glob('*.wav'))) == len(
        list((tmp_path / 'jax' / 'audio').glob('*.wav')))


@pytest.mark.slow
def test_eval_cli_on_a_jax_config(tmp_path):
    """The port's eval CLI on the ``config.yaml`` the JAX CLI dumped (its
    factories under ``tssep_tpu.``) with the JAX checkpoint, ``--cpu``,
    against JAX's evaluate; without ``--cpu`` and without CUDA it raises."""
    from tssep_tpu.config.configurable import from_config as jax_from_config
    from tssep_tpu.eval.run import evaluate as jax_evaluate
    from tssep_tpu.train import run as jax_run
    from tssep_tpu_torch.eval import run
    cfg = _reduced_sep(tmp_path / 'sep')
    config = jax_run.build_config([], {})
    config['eg'] = cfg['eg']
    from tssep_tpu.train.experiment import Experiment as JaxExperiment
    config['eg'] = JaxExperiment.get_config(cfg['eg'])
    jeg = jax_run.init(config)
    jeg.trainer.ensure_init()
    _save_confident(jeg.trainer)
    want = jax_evaluate(jax_from_config(config['eg']), out=tmp_path / 'jax',
                        driver_overrides=_SHORT)
    yaml_path = tmp_path / 'sep' / 'config.yaml'
    assert 'tssep_tpu.tasks.model.Model' in yaml_path.read_text()
    args = ['with', str(yaml_path), f'out={tmp_path / "port"}',
            *(f'driver.{k}={v}' for k, v in _SHORT.items())]
    got = run.main([*args, '--cpu'])
    _summary_close(got, want)
    assert json.loads((tmp_path / 'port' / 'metrics.json').read_text())[
        'summary'] == got['summary']
    with mock.patch.object(torch.cuda, 'is_available', lambda: False):
        with pytest.raises(RuntimeError, match='--cpu'):
            run.main(args)
