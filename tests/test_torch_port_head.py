"""The port's bfloat16 head (``head_dtype``, JAX's ``TSSEP_HEAD_BF16=1``)
against ``tssep_tpu`` with that mode on, on the CPU.

The JAX side reads the mode from two module constants,
``tssep_tpu.nn.estimator.HEAD_DTYPE`` (the head's logits,
``estimator.py:271``) and ``tssep_tpu.signal.stft._HEAD_BF16`` (the loss's
ISTFT segments, ``stft.py:304-309``); the tests set both with
``monkeypatch`` and trace JAX's functions afresh, so no compiled function
holds the old value. The model is ``tests/test_torch_port_train.py``'s small
TS-SEP configuration in float32 storage, so only the head differs from the
float32 path; weights are drawn with numpy on JAX's parameter tree and
carried across by name, inputs made with numpy from a seed.

Tolerances, stated for bfloat16 (8 bits of mantissa, one rounding a
relative 2^-9 at most): the logits, rounded once from float32 values that
agree to 1e-5, at one bf16 ulp (2^-8 of their magnitude, plus 1e-5). The
loss at one bf16 ulp (2^-8) of its value: the two packages round the ISTFT
differently (JAX sums the overlap-add in bfloat16 piece by piece, the port
in float32 and rounds the waveform once), so the waveforms differ by a few
bf16 ulps, and the LogMAE loss, a log of a mean over them, by much less
(5e-4 seen). Each parameter's gradient at 2^-5 of that gradient's max,
eight bf16 ulps: JAX's cotangents stay in bfloat16 through the sigmoid, the
head and the ISTFT's products, where the port's are rounded at the casts
and then carried in float32 (up to 1.3e-2 seen, at the head's linear
layer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tssep_tpu.nn import estimator as jax_estimator
from tssep_tpu.nn import rnnp as jax_rnnp
from tssep_tpu.signal import stft as jax_stft
from tssep_tpu.tasks.model import Model as JaxModel
from tssep_tpu.train.checkpoint import params_to_named
from tssep_tpu_torch.compat.from_jax import load_named
from tssep_tpu_torch.tasks.model import Model
from tssep_tpu_torch.train.run import runtime_options

F32, BF16 = torch.float32, torch.bfloat16
TARGET = 'speaker_reverberation_early_ch0'
LOSS_RTOL = 2 ** -8
GRAD_RTOL = 2 ** -5
CONFIG = {
    'fe': {'size': 64, 'shift': 16, 'window': 'hann'},
    'mask_estimator': {'units': 16, 'projs': 12, 'combination': 'mul',
                       'ts_vad': 3, 'aux_net_output_size': 33,
                       'output_resolution': 'tf'},
}


@pytest.fixture
def jax_head_bf16(monkeypatch):
    """JAX's bf16 head mode, as ``TSSEP_HEAD_BF16=1`` sets it at import,
    with one scan step per iteration (the same values, compiled faster)."""
    monkeypatch.setattr(jax_estimator, 'HEAD_DTYPE', jnp.bfloat16)
    monkeypatch.setattr(jax_stft, '_HEAD_BF16', True)
    monkeypatch.setattr(jax_rnnp, 'DEFAULT_UNROLL', 1)


def _batch(B=2, S=3, A=33, samples=1200, seed=3):
    rng = np.random.default_rng(seed)
    return {'observation': rng.standard_normal((B, 1, samples)).astype(
                np.float32),
            'auxInput': rng.uniform(0, 1, (B, S, A)).astype(np.float32),
            TARGET: 0.3 * rng.standard_normal((B, S, samples)).astype(
                np.float32),
            'reference_channel': 0}


def _models():
    jm = JaxModel.new(CONFIG)
    rng = np.random.default_rng(0)
    params = jax.tree.map(    # numpy values on eval_shape's tree: no jit
        lambda leaf: jnp.asarray(rng.uniform(-0.3, 0.3, leaf.shape).astype(
            np.float32)), jax.eval_shape(jm.init_params,
                                         jax.random.PRNGKey(0)))
    ours = Model.from_config(CONFIG, storage_dtype=F32, head_dtype=BF16,
                             device='cpu')
    load_named(ours, params_to_named(params))
    return jm, params, ours


def _torch(ex):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in ex.items()}


def test_bf16_head_logits_match_jax(jax_head_bf16):
    jm, params, ours = _models()
    ex = _batch()
    arrays = {k: jnp.asarray(v) for k, v in ex.items()
              if isinstance(v, np.ndarray)}
    want = jax.jit(lambda p, a: jm.forward(p, dict(a, reference_channel=0)))(
        params, arrays)
    got = ours(_torch(ex))
    assert want.logit.dtype == jnp.bfloat16
    assert got.logit.dtype == got.mask.dtype == BF16
    want_logit = np.asarray(want.logit.astype(jnp.float32))
    np.testing.assert_allclose(got.logit.float().numpy(), want_logit,
                               rtol=2 ** -8, atol=1e-5)
    # the waveform synthesized from bf16 segments is bf16, as JAX's is
    assert got.time_estimate.dtype == BF16


def test_bf16_head_loss_and_gradients_match_jax(jax_head_bf16):
    """LogMAE, the TS-SEP loss, through the bf16 head and the bf16 ISTFT
    segments: the loss (float32, upcast in the loss as in JAX) and every
    parameter's gradient."""
    jm, params, ours = _models()
    ex = _batch()
    arrays = {k: jnp.asarray(v) for k, v in ex.items()
              if isinstance(v, np.ndarray)}
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(
        lambda p, a: jm.loss_fn(p, dict(a, reference_channel=0), None, True),
        has_aux=True))(params, arrays)
    loss, _ = ours.loss_fn(_torch(ex))
    assert loss.dtype == F32
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss),
                               rtol=LOSS_RTOL)
    named = dict(ours.named_parameters())
    ref_named = params_to_named(ref_grads)
    assert sorted(named) == sorted(ref_named)
    for name, want in ref_named.items():
        want = np.asarray(want)
        err = np.abs(named[name].grad.numpy() - want).max()
        assert err <= GRAD_RTOL * np.abs(want).max(), (name, err)


def test_head_dtype_defaults_and_switch():
    """The head stays float32 without the switch, as JAX without the
    variable; ``runtime_options`` reads ``TSSEP_HEAD_BF16`` as JAX does."""
    assert Model.from_config(CONFIG, device='cpu').mask_estimator \
        .head_dtype == F32
    assert runtime_options(['--cpu'], {})['head_dtype'] == F32
    assert runtime_options(['--cpu'], {'TSSEP_HEAD_BF16': '0'})[
        'head_dtype'] == F32
    assert runtime_options(['--cpu'], {'TSSEP_HEAD_BF16': '1'})[
        'head_dtype'] == BF16
    ours = Model.from_config(CONFIG, storage_dtype=F32, device='cpu',
                             **{k: v for k, v in runtime_options(
                                 ['--cpu'], {'TSSEP_HEAD_BF16': '1'}).items()
                                if k not in ('device', 'storage_dtype')})
    assert ours.mask_estimator.head_dtype == BF16
