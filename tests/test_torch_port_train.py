"""The port's training slice against ``tssep_tpu`` on the CPU: the on-device
simulator on fixed draws, ``LogMAE``, ``Model.loss_fn`` with every parameter
gradient, one clipped Adam step, and the trainer.

Inputs are made with numpy from a seed (or, for the simulator, drawn by JAX
in the split order of ``tssep_tpu/data/device_sim.py``) and handed to both
packages. Tolerances:
- simulator 1e-5 of each tensor's peak: the same float32 arithmetic, with
  sin/cos of angles up to 2 pi f0 t from two libraries, and an FFT against
  a DFT product in the enrollment STFT;
- losses 1e-5: one float32 reduction in another order;
- ``Model.loss_fn``: the loss at 1e-4 and each gradient's max abs error at
  1e-4 of that gradient's max, as in ``tests/test_kernels.py``: the JAX side
  runs its scan path, the port its plain kernel versions (float32), summed
  in other orders through four recurrent layers and their backward;
- Adam 1e-6 on the clipped gradients (relative) and 2e-7 on the updated
  parameters: the same float32 formula.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tssep_tpu.data.device_sim import DeviceMeetingSimulator as JaxSim
from tssep_tpu.tasks import losses as jax_losses
from tssep_tpu.tasks.model import Model as JaxModel
from tssep_tpu.train.checkpoint import params_to_named
from tssep_tpu.train.optimizer import Adam as JaxAdam
from tssep_tpu_torch.compat.from_jax import load_named
from tssep_tpu_torch.data.device_sim import (DeviceMeetingSimulator,
                                             DeviceSimDataset)
from tssep_tpu_torch.nn.rnnp import inverted_dropout
from tssep_tpu_torch.tasks import losses
from tssep_tpu_torch.tasks.model import Model
from tssep_tpu_torch.train.optimizer import Adam, AMSGrad, MultiSteps
from tssep_tpu_torch.train.trainer import Trainer

F32 = torch.float32
TARGET = 'speaker_reverberation_early_ch0'


def _np(x):
    return np.array(x)          # a writable copy, for torch.from_numpy


# -- simulator ---------------------------------------------------------------

SIM = dict(duration=0.5, num_speakers=3, aux_size=65, enroll_seconds=0.25)


def _jax_draws(sim, key, batch):
    """The draws of ``generate`` in its split order (device_sim.py:112-135,
    ``_sources`` :75-77), in the port's ``draw`` layout."""
    s, h = sim.num_speakers, sim.n_harmonics
    k_f0, k_amp, k_src, k_enr, k_noise = jax.random.split(key, 5)
    draws = {
        'f0s': jnp.exp(jax.random.uniform(
            k_f0, (batch, s), minval=np.log(sim.f0_min),
            maxval=np.log(sim.f0_max))),
        'amps': jax.random.uniform(k_amp, (batch, s, h), minval=0.05,
                                   maxval=1.0) / jnp.arange(1, h + 1),
        'noise': jax.random.normal(k_noise, (batch, sim.num_samples)),
    }
    for prefix, k in (('src', k_src), ('enr', k_enr)):
        k_phase, k_am_f, k_am_p = jax.random.split(k, 3)
        draws[f'{prefix}_phases'] = jax.random.uniform(
            k_phase, (batch, s, h), maxval=2 * np.pi)
        draws[f'{prefix}_am_f'] = jax.random.uniform(
            k_am_f, (batch, s, 1), minval=1.0, maxval=4.0)
        draws[f'{prefix}_am_p'] = jax.random.uniform(
            k_am_p, (batch, s, 1), maxval=2 * np.pi)
    return {k: torch.from_numpy(_np(v)) for k, v in draws.items()}


@pytest.mark.parametrize('seed,batch', [(0, 2), (7, 3)])
def test_simulator_from_draws_matches_jax(seed, batch):
    key = jax.random.PRNGKey(seed)
    ref = JaxSim(**SIM).generate(key, batch)
    sim = DeviceMeetingSimulator(**SIM)
    got = sim.from_draws(_jax_draws(JaxSim(**SIM), key, batch))
    assert got['reference_channel'] == ref['reference_channel'] == 0
    for name in ('observation', 'auxInput', 'Vad', TARGET):
        want = np.asarray(ref[name])
        assert tuple(got[name].shape) == want.shape, name
        np.testing.assert_allclose(got[name].numpy(), want,
                                   atol=1e-5 * np.abs(want).max(), rtol=0,
                                   err_msg=name)


def test_simulator_draws_on_the_generator_device():
    sim = DeviceMeetingSimulator(**SIM)
    gen = torch.Generator().manual_seed(0)
    a = sim.generate(gen, 2)
    b = sim.generate(torch.Generator().manual_seed(0), 2)
    torch.testing.assert_close(a['observation'], b['observation'])
    assert a['observation'].shape == (2, 1, sim.num_samples)
    assert a['auxInput'].shape == (2, 3, 65)
    assert a['Vad'].shape == (2, 3, 35)
    draws = sim.draw(gen, 2)
    assert all(v.device == torch.device('cpu') for v in draws.values())


# -- losses ------------------------------------------------------------------

def _loss_inputs(seed=0, B=2, S=3, T=400):
    rng = np.random.default_rng(seed)
    est = rng.standard_normal((B, S, T)).astype(np.float32)
    tgt = rng.standard_normal((B, S, T)).astype(np.float32)
    mask = np.zeros((B, 1, T), np.float32)
    mask[0, 0, :T] = 1
    mask[1, 0, :T // 3] = 1
    return est, tgt, mask


class _Out:
    def __init__(self, time_estimate):
        self.time_estimate = time_estimate


@pytest.mark.parametrize('pit,masked', [(False, False), (False, True),
                                        (True, False)])
def test_log_mae_matches_jax(pit, masked):
    est, tgt, mask = _loss_inputs()
    ex_np = {TARGET: tgt}
    if masked:
        ex_np['_sample_mask'] = mask
    ref = jax_losses.LogMAE(pit=pit).from_ex_out(
        {k: jnp.asarray(v) for k, v in ex_np.items()},
        _Out(jnp.asarray(est)), None)
    got = losses.LogMAE(pit=pit).from_ex_out(
        {k: torch.from_numpy(v) for k, v in ex_np.items()},
        _Out(torch.from_numpy(est)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_pit_minimum_finds_the_permutation():
    est, _, _ = _loss_inputs(S=4)
    perm = [2, 0, 3, 1]
    plain = losses.LogMAE()(torch.from_numpy(est),
                            torch.from_numpy(est[:, perm]) + 0.5)
    pit = losses.LogMAE(pit=True)(torch.from_numpy(est),
                                  torch.from_numpy(est[:, perm]) + 0.5)
    torch.testing.assert_close(pit, torch.full_like(pit, np.log10(4 * 0.5)))
    assert (plain > pit).all()


def test_not_ported_losses_raise():
    """Every loss of the JAX package is ported: each name builds (a dotted
    path by its class name), and only an unknown one raises."""
    with pytest.raises(ValueError):
        losses.loss_from_config({'factory': 'NoSuchLoss'})
    assert isinstance(losses.loss_from_config({'factory': 'VADSigmoidBCE'}),
                      losses.VADSigmoidBCE)
    assert isinstance(losses.loss_from_config(
        {'factory': 'tssep_tpu.tasks.losses.LogMAE', 'pit': True}),
        losses.LogMAE)


# -- Model.loss_fn -----------------------------------------------------------

def _small_config(combination, ts_vad, explicit_vad, projs=12):
    """The small configurations of ``test_forward_matches_jax``."""
    return {
        'fe': {'size': 64, 'shift': 16, 'window': 'hann'},
        'mask_estimator': {
            'units': 16, 'projs': projs, 'combination': combination,
            'ts_vad': ts_vad,
            'aux_net_output_size': 33 if combination == 'mul' else 20,
            'output_resolution': 'tf', 'explicit_vad': explicit_vad,
        },
    }


def _batch(B, S, A, samples=1200, seed=3):
    rng = np.random.default_rng(seed)
    return {'observation': rng.standard_normal((B, 1, samples)).astype(
                np.float32),
            'auxInput': rng.uniform(0, 1, (B, S, A)).astype(np.float32),
            TARGET: 0.3 * rng.standard_normal((B, S, samples)).astype(
                np.float32),
            'reference_channel': 0}


@pytest.fixture
def scan_unroll_1():
    """The JAX scan path with one step per scan iteration: the same
    arithmetic as its default of 8, compiled in a fraction of the time."""
    from tssep_tpu.nn import rnnp as jax_rnnp
    saved = jax_rnnp.DEFAULT_UNROLL
    jax_rnnp.DEFAULT_UNROLL = 1
    yield
    jax_rnnp.DEFAULT_UNROLL = saved


@pytest.mark.parametrize('combination,ts_vad,explicit_vad,projs', [
    ('mul', 3, False, 12),
    ('cat', 4, True, 12),
    ('mul', 4, False, 520),     # stacked width 2080: the bidi Function
])
def test_loss_fn_and_gradients_match_jax(scan_unroll_1, combination, ts_vad,
                                         explicit_vad, projs):
    cfg = _small_config(combination, ts_vad, explicit_vad, projs)
    jm = JaxModel.new(cfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    ex = _batch(2, ts_vad, cfg['mask_estimator']['aux_net_output_size'])
    arrays = {k: jnp.asarray(v) for k, v in ex.items()
              if isinstance(v, np.ndarray)}

    @jax.jit
    def value_and_grad(p, arrays):
        return jax.value_and_grad(jm.loss_fn, has_aux=True)(
            p, dict(arrays, reference_channel=0), None, True)

    (ref_loss, _), ref_grads = value_and_grad(params, arrays)

    ours = Model.from_config(cfg, storage_dtype=F32, device='cpu')
    load_named(ours, params_to_named(params))
    loss, aux = ours.loss_fn({k: (torch.from_numpy(v) if isinstance(
        v, np.ndarray) else v) for k, v in ex.items()})
    loss.backward()
    assert aux['per_example_loss'].shape == (2,)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-4,
                               rtol=0)
    named = dict(ours.named_parameters())
    ref_named = params_to_named(ref_grads)
    assert sorted(named) == sorted(ref_named)
    for name, want in ref_named.items():
        want = np.asarray(want)
        err = np.abs(named[name].grad.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)


def test_dropout_draws_from_the_generator_only_in_training():
    """Inverted dropout keeps 1 - p of the values, scaled by 1 / (1 - p),
    with draws from the generator; the identity without one (or with
    p = 0), as JAX drops only when ``rng`` is given."""
    h = torch.ones(200, 50)
    dropped = inverted_dropout(h, 0.25, torch.Generator().manual_seed(0))
    kept = dropped != 0
    assert torch.all(dropped[kept] == 1 / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    torch.testing.assert_close(
        dropped, inverted_dropout(h, 0.25, torch.Generator().manual_seed(0)))
    assert inverted_dropout(h, 0.25, None) is h
    assert inverted_dropout(h, 0.0, torch.Generator()) is h

    # the same weights with and without dropout, the same speaker order
    cfg = _small_config('mul', 3, False)
    plain = Model.from_config(cfg, storage_dtype=F32, device='cpu')
    plain.init_params(torch.Generator().manual_seed(0))
    cfg['mask_estimator']['dropout'] = 0.5
    model = Model.from_config(cfg, storage_dtype=F32, device='cpu')
    model.load_state_dict(plain.state_dict())
    ex = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
          for k, v in _batch(2, 3, 33).items()}

    def mask(m, training):
        return m(ex, torch.Generator().manual_seed(1), training).mask

    torch.testing.assert_close(mask(model, False), mask(plain, False))
    torch.testing.assert_close(mask(plain, True), mask(plain, False))
    assert not torch.allclose(mask(model, True), mask(plain, True))


# -- optimizer ---------------------------------------------------------------

@pytest.mark.parametrize('grad_norm', [5.0, 20.0])
def test_adam_step_matches_optax(grad_norm):
    rng = np.random.default_rng(4)
    shapes = [(6, 5), (5,), (3, 4, 2)]
    values = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    scale = grad_norm / np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                    for g in grads))
    grads = [(g * scale).astype(np.float32) for g in grads]

    tx = JaxAdam(gradient_clipping=10, lr=1e-3).make()
    jp = [jnp.asarray(v) for v in values]
    state = tx.init(jp)
    clipped, _ = optax.clip_by_global_norm(10).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    params = [torch.nn.Parameter(torch.from_numpy(_np(v))) for v in values]
    opt = Adam(gradient_clipping=10, lr=1e-3).make(params)
    for step in range(2):       # the second step exercises bias correction
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = [p + u for p, u in zip(jp, updates)]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(_np(g))
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), grad_norm, rtol=1e-5)
        if step == 0:
            for p, want in zip(params, clipped):
                np.testing.assert_allclose(p.grad.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=0)
        for p, want in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       atol=2e-7, rtol=0)


def test_clip_scales_a_shared_gradient_once():
    """An LSTM layer's two biases get one gradient, and the layer's
    backward leaves their .grad as views of one tensor: the clip scales
    each once, as optax's ``clip_by_global_norm`` scales its two leaves."""
    from tssep_tpu_torch.nn.rnnp import RNNP
    layer = RNNP(5, elayers=1, cdim=4, hdim=3, storage_dtype=torch.float32,
                 device='cpu')
    layer.init_params(torch.Generator().manual_seed(0))
    x = torch.randn(2, 7, 5, generator=torch.Generator().manual_seed(1))
    (100 * layer(x)).square().sum().backward()
    params = [p for p in layer.parameters()]
    lstm = layer.lstm0
    assert lstm.bias_ih_l0.grad.data_ptr() == lstm.bias_hh_l0.grad.data_ptr()
    grads = [p.grad.numpy().copy() for p in params]
    clipped, _ = optax.clip_by_global_norm(1).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    opt = Adam(gradient_clipping=1, lr=1e-3).make(params)
    assert opt.step().item() > 1
    for p, want in zip(params, clipped):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=0)


def test_not_ported_adam_options_raise():
    """amsgrad, weight decay and multi-step accumulation are ported: each
    builds the update that optax chains for it (their trajectories against
    optax: ``tests/test_torch_port_recipe.py``)."""
    params = [torch.nn.Parameter(torch.zeros(1))]
    assert isinstance(Adam(amsgrad=True).make(params).update, AMSGrad)
    assert isinstance(Adam(weight_decay=0.1).make(params).update,
                      torch.optim.AdamW)
    assert isinstance(Adam().make(params, every_k_steps=2), MultiSteps)


# -- trainer -----------------------------------------------------------------

def _tiny_setup():
    cfg = _small_config('mul', 3, False)
    model = Model.from_config(cfg, storage_dtype=F32, device='cpu')
    model.init_params(torch.Generator().manual_seed(0))
    sim = DeviceMeetingSimulator(duration=0.075, num_speakers=3, aux_size=33,
                                 enroll_seconds=0.05)
    data = DeviceSimDataset(sim, batch=2, seed=1,
                            targets=model.loss.device_targets(), device='cpu')
    return model, data


def test_trainer_takes_steps_with_finite_losses():
    model, data = _tiny_setup()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, None,
                      optimizer=Adam(gradient_clipping=10, lr=1e-3), seed=0)
    losses_ = trainer.train_steps(data, 2)
    assert len(losses_) == 2 and all(np.isfinite(losses_))
    assert trainer.iteration == 2
    assert any(not torch.equal(before[k], v)
               for k, v in model.state_dict().items())


def test_trainer_raises_on_a_non_finite_loss():
    model, data = _tiny_setup()
    good = next(iter(data))
    bad = dict(good, observation=torch.full_like(good['observation'],
                                                 float('nan')))
    with pytest.raises(RuntimeError, match='Non-finite loss'):
        Trainer(model, None, seed=0).train_steps([good, bad], 2)
