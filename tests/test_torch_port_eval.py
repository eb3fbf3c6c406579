"""The port's eval building blocks against ``tssep_tpu``'s, on the same numpy
inputs made from a seed: ``signal/intervals.py``, ``stft_vad``/``istft_vad``,
the dummy spatial fixture, every metric, every beamformer vector, the numpy
WPE and ``ClassicBF`` (exact or at 1e-12: the same float64 numpy code), and
the torch WPE against ``wpe_jax`` at 1e-4 (on the CPU: the host form in
float64, the ``(re, im)`` form in float32, ``wpe_jax``'s arithmetic).
"""

import numpy as np
import pytest
import torch

from tssep_tpu.data import dummy as jax_dummy
from tssep_tpu.eval import beamformer as jax_bf
from tssep_tpu.eval import classic_bf as jax_cbf
from tssep_tpu.eval import metrics as jax_metrics
from tssep_tpu.eval import wpe as jax_wpe
from tssep_tpu.signal import intervals as jax_iv
from tssep_tpu.signal import vad as jax_vad
from tssep_tpu_torch.data import dummy
from tssep_tpu_torch.eval import beamformer as bf
from tssep_tpu_torch.eval import classic_bf as cbf
from tssep_tpu_torch.eval import metrics
from tssep_tpu_torch.eval import wpe as port_wpe
from tssep_tpu_torch.signal import intervals as iv
from tssep_tpu_torch.signal import vad

EXACT = 1e-12


def _same_ai(a, b):
    assert a.normalized_intervals == b.normalized_intervals
    assert a.shape == b.shape


# -- intervals -----------------------------------------------------------------

@pytest.mark.parametrize('seed', range(3))
def test_intervals_match_jax(seed):
    rng = np.random.default_rng(seed)
    arr = rng.random(200) > 0.6
    a, b = iv.from_array(arr), jax_iv.from_array(arr)
    _same_ai(a, b)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _same_ai(~a, ~b)
    _same_ai(a[17:150], b[17:150])
    assert [a[i] for i in range(0, 200, 7)] == [b[i] for i in range(0, 200, 7)]
    for value, (s, e) in [(True, (30, 60)), (False, (5, 100)),
                          (True, (-20, -1))]:
        a[s:e] = value
        b[s:e] = value
        _same_ai(a, b)
    assert a.sum() == b.sum() and repr(a) == repr(b)
    text = '0:55,60:70,90:91'
    _same_ai(iv.from_str(text, shape=100), jax_iv.from_str(text, shape=100))
    _same_ai(iv.zeros(9), jax_iv.zeros(9))
    _same_ai(iv.ones(9), jax_iv.ones(9))
    _same_ai(iv.ArrayInterval([(5, 9), (0, 6), (20, 21)]),
             jax_iv.ArrayInterval([(5, 9), (0, 6), (20, 21)]))


# -- sample <-> frame activity ----------------------------------------------------

@pytest.mark.parametrize('window_length,shift,fading', [
    (64, 16, True), (1024, 256, True), (400, 160, 'half'), (64, 32, False)])
def test_vad_conversions_match_jax(window_length, shift, fading):
    rng = np.random.default_rng(window_length + shift)
    samples = (rng.random((3, 700)) > 0.5).repeat(4, axis=-1)
    args = (window_length, shift, fading)
    frames = vad.stft_vad(samples, *args)
    np.testing.assert_array_equal(frames, jax_vad.stft_vad(samples, *args))
    _same_ai(vad.stft_vad(iv.ArrayInterval(samples[0]), *args),
             jax_vad.stft_vad(jax_iv.ArrayInterval(samples[0]), *args))
    listed = vad.stft_vad([iv.ArrayInterval(s) for s in samples], *args)
    assert [a.normalized_intervals for a in listed] == [
        a.normalized_intervals for a in jax_vad.stft_vad(
            [jax_iv.ArrayInterval(s) for s in samples], *args)]
    for got, want in zip(vad.istft_vad(frames, *args),
                         jax_vad.istft_vad(frames, *args)):
        _same_ai(got, want)
    _same_ai(vad.istft_vad(frames[1], *args),
             jax_vad.istft_vad(frames[1], *args))
    for got, want in zip(
            vad.istft_vad([iv.ArrayInterval(f) for f in frames], *args),
            jax_vad.istft_vad([jax_iv.ArrayInterval(f) for f in frames],
                              *args)):
        _same_ai(got, want)


# -- the spatial fixture ------------------------------------------------------------

@pytest.mark.parametrize('seed,bins', [(0, 5), (3, 17)])
def test_dummy_spatial_fixture_matches_jax(seed, bins):
    got = dummy.simple_toy_example(seed, bins)
    want = jax_dummy.simple_toy_example(seed, bins)
    for key in ('Observation', 'Speech_reverberation_early', 'mask'):
        np.testing.assert_array_equal(got[key], want[key])
    for a, b in zip(got['Vad'], want['Vad']):
        _same_ai(a, b)
    cov = np.eye(4) + 0.5
    np.testing.assert_array_equal(
        dummy.sample_cacg((7,), cov, np.random.RandomState(seed)),
        jax_dummy.sample_cacg((7,), cov, np.random.RandomState(seed)))
    sig = np.random.default_rng(seed).standard_normal((3, 4, 9, bins))
    np.testing.assert_array_equal(
        dummy.wiener_like_mask(sig, sensor_axis=1),
        jax_dummy.wiener_like_mask(sig, sensor_axis=1))


# -- metrics ---------------------------------------------------------------------------

def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((3, 900))
    est = ref[[1, 0, 2]] + 0.3 * rng.standard_normal((3, 900))
    est[2] = 0.0                                  # a silent estimate: -inf
    np.testing.assert_array_equal(metrics.si_sdr(ref, est),
                                  jax_metrics.si_sdr(ref, est))
    np.testing.assert_allclose(metrics.ci_sdr(ref, est, taps=32),
                               jax_metrics.ci_sdr(ref, est, taps=32),
                               atol=EXACT, rtol=0)
    for perm in (False, True):
        got = metrics.bss_eval_sources_sdr(
            ref[:2], est[:2], taps=8, compute_permutation=perm,
            return_permutation=True)
        want = jax_metrics.bss_eval_sources_sdr(
            ref[:2], est[:2], taps=8, compute_permutation=perm,
            return_permutation=True)
        np.testing.assert_allclose(got[0], want[0], atol=EXACT, rtol=0)
        np.testing.assert_array_equal(got[1], want[1])
    scores = rng.standard_normal((4, 4))
    for maximize in (True, False):
        np.testing.assert_array_equal(
            metrics.pit_permutation(scores, maximize),
            jax_metrics.pit_permutation(scores, maximize))
    act_ref = rng.random((3, 400)) > 0.5
    act_hyp = rng.random((4, 380)) > 0.5
    for kwargs in ({}, {'collar': 3}, {'collar': 0.05, 'frame_shift': 0.01},
                   {'optimal_mapping': False}):
        assert metrics.der(act_ref, act_hyp, **kwargs) == jax_metrics.der(
            act_ref, act_hyp, **kwargs)


# -- beamformers -------------------------------------------------------------------------

def _psds(seed=0, f=9, d=6, t=60):
    rng = np.random.default_rng(seed)
    obs = (rng.standard_normal((f, d, t))
           + 1j * rng.standard_normal((f, d, t)))
    mask = rng.random((2, f, t))
    return obs, mask


@pytest.mark.parametrize('symmetrize', ['real', 'hermitian'])
def test_beamformer_vectors_match_jax(symmetrize):
    obs, mask = _psds()
    got_t, got_n = bf.get_psd(mask, obs, mask_power=2, symmetrize=symmetrize)
    want_t, want_n = jax_bf.get_psd(mask, obs, mask_power=2,
                                    symmetrize=symmetrize)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_array_equal(bf.condition_covariance(got_n, 1e-3),
                                  jax_bf.condition_covariance(got_n, 1e-3))
    for name, kwargs in [('mvdr_souden', {'ref_channel': 1}),
                         ('wmwf', {'reference_channel': 0}),
                         ('rank1_gev+mvdr_souden', {'ref_channel': 0}),
                         ('scaled_gev_atf+mvdr', {'ref_channel': 0}),
                         ('ch0', {}), ('ch1', {})]:
        got = bf.get_bf_vector(name, got_t, got_n, **kwargs)
        want = jax_bf.get_bf_vector(name, want_t, want_n, **kwargs)
        np.testing.assert_allclose(got, want, atol=EXACT, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(bf.apply_beamforming_vector(got, obs),
                                   jax_bf.apply_beamforming_vector(want, obs),
                                   atol=EXACT, rtol=0, err_msg=name)
    for fn in ('gev', 'gev_atf'):
        np.testing.assert_allclose(getattr(bf, fn)(got_t, got_n),
                                   getattr(jax_bf, fn)(want_t, want_n),
                                   atol=EXACT, rtol=0, err_msg=fn)
    w = bf.gev(got_t, got_n)
    np.testing.assert_allclose(bf.blind_analytic_normalization(w, got_n),
                               jax_bf.blind_analytic_normalization(w, want_n),
                               atol=EXACT, rtol=0)


# -- WPE ----------------------------------------------------------------------------------

@pytest.mark.parametrize('kwargs', [
    {}, {'statistics_mode': 'valid'}, {'psd_context': 2, 'taps': 4},
    {'taps': 3, 'delay': 1, 'iterations': 2}])
def test_numpy_wpe_matches_jax(kwargs):
    rng = np.random.default_rng(1)
    y = rng.standard_normal((3, 50, 4)) + 1j * rng.standard_normal((3, 50, 4))
    np.testing.assert_allclose(port_wpe.WPE(**kwargs)(y),
                               jax_wpe.WPE(**kwargs)(y), atol=EXACT, rtol=0)
    np.testing.assert_allclose(port_wpe.ChannelWiseWPE(**kwargs)(y),
                               jax_wpe.ChannelWiseWPE(**kwargs)(y),
                               atol=EXACT, rtol=0)
    yf = np.transpose(y, (2, 0, 1))
    np.testing.assert_allclose(port_wpe.wpe(yf, **kwargs),
                               jax_wpe.wpe(yf, **kwargs), atol=EXACT, rtol=0)


def test_torch_wpe_matches_wpe_jax():
    """``wpe_torch`` against ``wpe_jax`` at 1e-4: the host form (float64)
    and the device (re, im) form in float32 (``wpe_jax``'s arithmetic). The
    ``WPE`` wrapper (the ``'torch'`` backend, float64; a JAX configuration's
    ``backend: jax`` reads as it) against ``wpe_jax`` at 1e-4 and against
    the numpy WPE at 1e-9."""
    rng = np.random.default_rng(2)
    y = (rng.standard_normal((5, 3, 60))
         + 1j * rng.standard_normal((5, 3, 60))).astype(np.complex64)
    want = jax_wpe.wpe_jax(y, taps=4, delay=2, iterations=2)
    got = port_wpe.wpe_torch(y, taps=4, delay=2, iterations=2, device='cpu')
    assert got.dtype == np.complex128
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    xr, xi = port_wpe.wpe_torch((torch.as_tensor(y.real),
                                 torch.as_tensor(y.imag)),
                                taps=4, delay=2, iterations=2)
    np.testing.assert_allclose(xr.numpy() + 1j * xi.numpy(), want,
                               atol=1e-4, rtol=0)
    obs = np.transpose(y, (1, 2, 0)).astype(np.complex128)
    for backend in ('torch', 'jax'):
        wrapped = port_wpe.WPE(taps=4, iterations=2, backend=backend,
                               device='cpu')
        assert wrapped.backend == 'torch'
        out = wrapped(obs)
        assert out.dtype == np.complex128
        np.testing.assert_allclose(
            out, jax_wpe.WPE(taps=4, iterations=2, backend='jax')(obs),
            atol=1e-4, rtol=0)
        np.testing.assert_allclose(
            out, jax_wpe.WPE(taps=4, iterations=2)(obs), atol=1e-9, rtol=0)
    with pytest.raises(ValueError, match='backend'):
        port_wpe.WPE(backend='tpu')


# -- ClassicBF ---------------------------------------------------------------------------------

@pytest.fixture(scope='module')
def toy():
    return dummy.simple_toy_example(frequency_bins=17)


@pytest.mark.parametrize('kwargs', [
    {}, {'bf': 'wmwf'}, {'bf': 'rank1_gev+mvdr_souden'},
    {'masking': True, 'masking_eps': 0.1},
    {'distortion_mask': {'factory': 'OneMinus'}},
    {'pre_wpe': 'numpy', 'segment_wpe': 'numpy'}])
def test_classic_bf_matches_jax(toy, kwargs):
    """``ClassicBF`` on the 6-mic spatial fixture, with WPE off and on."""
    kwargs = dict(kwargs)
    wpe_kw = {}
    for key in ('pre_wpe', 'segment_wpe'):
        if key in kwargs:
            kwargs.pop(key)
            wpe_kw[key] = dict(taps=3, iterations=1)
    port_kw = dict(kwargs, **{k: port_wpe.WPE(**v)
                              for k, v in wpe_kw.items()})
    jax_kw = dict(kwargs, **{k: jax_wpe.WPE(**v) for k, v in wpe_kw.items()})
    if 'distortion_mask' in kwargs:
        port_kw['distortion_mask'] = cbf.OneMinus()
        jax_kw['distortion_mask'] = jax_cbf.OneMinus()
        masks = toy['mask'][:1, None]
        dia_port, dia_jax = toy['Vad'][:1], [
            jax_iv.ArrayInterval(list(a.normalized_intervals), shape=79)
            for a in toy['Vad'][:1]]
    else:
        masks = toy['mask'][:-1, None]
        dia_port = toy['Vad']
        dia_jax = [jax_iv.ArrayInterval(list(a.normalized_intervals),
                                        shape=79) for a in toy['Vad']]
    got = cbf.ClassicBF(**port_kw, device='cpu')(masks, toy['Observation'],
                                                 dia_port)
    want = jax_cbf.ClassicBF(**jax_kw)(masks, toy['Observation'], dia_jax)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=EXACT, rtol=0)


def test_distortion_masks_match_jax():
    m = np.random.default_rng(3).random((1, 3, 5, 4))
    np.testing.assert_array_equal(cbf.SumCrossTalker(0.01)(m),
                                  jax_cbf.SumCrossTalker(0.01)(m))
    np.testing.assert_array_equal(cbf.OneMinus()(m[:, :1]),
                                  jax_cbf.OneMinus()(m[:, :1]))
    assert cbf.ClassicBF_np is cbf.ClassicBF
