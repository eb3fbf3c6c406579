"""The toy recipe's model options and its two stages in the port, against
``tssep_tpu`` on the CPU: normalizers and aux nets, the GRU arms, the losses,
the enhancers, the optimizer options, ``load_named`` on the new parameters,
and ``Model.from_config`` of the TS-VAD and the TS-SEP stage of
``tssep_tpu/exp/init_cfg_*.yaml`` at the recipe's own widths.

Inputs are made with numpy from a seed and handed to both packages; weights
are the JAX package's, carried across by name (``compat/from_jax.py``).
Tolerances: normalizers and aux nets 1e-5 (one float32 reduction in another
order); the GRU 1e-4 on outputs and gradients (float32 through two
recurrent layers and their backward); losses 1e-5; the MVDR 1e-4 of the
estimate's peak (a complex64 solve per frequency); the optimizers 1e-6 on
the parameter trajectories (the same float32 formulas); the recipe models
1e-4 on masks, loss and each gradient relative to its peak, as
``tests/test_torch_port_train.py`` compares ``Model.loss_fn``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from tssep_tpu.config.configurable import nested_merge
from tssep_tpu.nn import estimator as jax_est
from tssep_tpu.nn import norm as jax_norm
from tssep_tpu.nn.rnnp import RNNP as JaxRNNP
from tssep_tpu.tasks import enhancer as jax_enh
from tssep_tpu.tasks import losses as jax_losses
from tssep_tpu.tasks.model import Model as JaxModel
from tssep_tpu.train import optimizer as jax_opt
from tssep_tpu.train.checkpoint import params_to_named
from tssep_tpu_torch.compat.from_jax import load_named
from tssep_tpu_torch.features.extractor import ConcatenatedSTFTFeatures
from tssep_tpu_torch.nn import estimator, norm, rnnp
from tssep_tpu_torch.signal.vad import stft_vad
from tssep_tpu_torch.tasks import enhancer, losses
from tssep_tpu_torch.tasks.model import Model
from tssep_tpu_torch.train import optimizer
from tssep_tpu_torch.train.trainer import Trainer

F32 = torch.float32
EXP = Path(__file__).resolve().parents[1] / 'tssep_tpu/exp'


@pytest.fixture
def scan_unroll_1():
    """The JAX scan path with one step per scan iteration: the same
    arithmetic as its default of 8, compiled in a fraction of the time."""
    from tssep_tpu.nn import rnnp as jax_rnnp
    saved = jax_rnnp.DEFAULT_UNROLL
    jax_rnnp.DEFAULT_UNROLL = 1
    yield
    jax_rnnp.DEFAULT_UNROLL = saved


def _jax_params(init, seed=0):
    """A JAX params tree with ``init``'s names and shapes
    (``jax.eval_shape``: no JAX draw to compile), its values drawn by numpy
    from ``seed``."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda leaf: jnp.asarray(rng.uniform(-0.2, 0.2, leaf.shape).astype(
            np.float32)), jax.eval_shape(init, jax.random.PRNGKey(0)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _close_to_peak(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, peak = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * peak, (err, peak)


# -- nn/norm.py and the aux nets -----------------------------------------------

@pytest.mark.parametrize('ours,ref', [
    (norm.InstanceNorm(), jax_norm.InstanceNorm()),
    (norm.InstanceNorm(dim=-2, unbiased=True),
     jax_norm.InstanceNorm(dim=-2, unbiased=True)),
    (norm.InstanceNorm_v2(), jax_norm.InstanceNorm_v2()),
    (norm.InstanceNorm_v2(mean_dim=-2, norm_dim=-1),
     jax_norm.InstanceNorm_v2(mean_dim=-2, norm_dim=-1))])
def test_normalizer_matches_jax(ours, ref):
    x = np.random.default_rng(0).standard_normal((2, 3, 9, 7)).astype(
        np.float32)
    _close(ours(_t(x)), ref(jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize('kind', ['LinearAux', 'AuxNet', 'AuxNet lengths',
                                  'AuxNet normalizer'])
def test_aux_net_matches_jax(kind):
    """``AuxNet``'s mean over the aux frames, all of them or the first
    ``lengths``; ``LinearAux``'s projection."""
    rng = np.random.default_rng(1)
    aux = rng.standard_normal((2, 3, 5, 12)).astype(np.float32)
    lengths = np.array([[5, 2, 3], [1, 4, 5]]) if 'lengths' in kind else None
    if kind == 'LinearAux':
        ours = estimator.LinearAux(12, 7, device='cpu')
        ref = jax_est.LinearAux(12, 7)
        aux = aux[:, :, 0]
    else:
        normalizer = {'factory': 'InstanceNorm'} if 'normalizer' in kind \
            else None
        ours = estimator.AuxNet(12, normalizer=normalizer, device='cpu')
        ref = jax_est.AuxNet(12, normalizer=(
            jax_norm.InstanceNorm() if normalizer else None))
    params = ref.init(jax.random.PRNGKey(0))
    load_named(ours, params_to_named(params))
    got = ours(_t(aux), None if lengths is None else _t(lengths))
    _close(got.detach(), ref.apply(params, jnp.asarray(aux),
                                   None if lengths is None
                                   else jnp.asarray(lengths)), 1e-5)


def test_load_named_carries_an_aux_net_strictly():
    """A JAX estimator with an ``AuxNet`` loads by name into the port's
    (``mask_estimator.aux_net.linear0.weight``, ...), and a missing name
    raises."""
    args = dict(idim=10, odim=10, layers=2, units=6, projs=5,
                combination='mul', aux_net_output_size=10)
    ref = jax_est.MaskEstimator(aux_net={'factory': jax_est.AuxNet,
                                         'idim': 10}, **args)
    named = params_to_named(_jax_params(ref.init, 2))
    assert 'aux_net.linear2.bias' in named
    ours = estimator.MaskEstimator(aux_net={'factory': 'AuxNet', 'idim': 10},
                                   storage_dtype=F32, device='cpu', **args)
    load_named(ours, named)
    for name, value in named.items():
        np.testing.assert_array_equal(ours.state_dict()[name].numpy(), value)
    del named['aux_net.linear1.weight']
    with pytest.raises(RuntimeError):
        load_named(ours, named)


def test_estimator_with_aux_net_and_normalizer_matches_jax(scan_unroll_1):
    """The aux net over aux frames, the input normalizer before ``pre_net``
    and the conditioning: the estimator's masks against JAX's."""
    args = dict(idim=10, odim=9, layers=2, units=6, projs=5,
                combination='cat', ts_vad=3)
    ref = jax_est.MaskEstimator(
        aux_net={'factory': jax_est.LinearAux, 'idim': 9, 'odim': 4},
        aux_net_output_size=4, input_normalizer={
            'factory': jax_norm.InstanceNorm_v2}, **args)
    params = _jax_params(ref.init, 3)
    ours = estimator.MaskEstimator(
        aux_net={'factory': 'LinearAux', 'idim': 9, 'odim': 4},
        aux_net_output_size=4,
        input_normalizer={'factory': 'InstanceNorm_v2'}, storage_dtype=F32,
        device='cpu', **args)
    load_named(ours, params_to_named(params))
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((2, 11, 10)).astype(np.float32)
    aux = rng.standard_normal((2, 3, 9)).astype(np.float32)
    want = jax.jit(ref.apply)(params, jnp.asarray(xs), jnp.asarray(aux))
    with torch.no_grad():
        got = ours(_t(xs), _t(aux))
    _close(got.mask, want.mask, 1e-4)


# -- the GRU arms --------------------------------------------------------------

@pytest.mark.parametrize('typ', ['bgru', 'gru'])
def test_gru_rnnp_matches_jax_vjp(scan_unroll_1, typ):
    """A two-layer GRU RNNP: outputs and every parameter's gradient against
    ``jax.vjp`` of the JAX ``RNNP`` (its ``lax.scan`` GRU)."""
    jr = JaxRNNP(idim=7, elayers=2, cdim=6, hdim=5, typ=typ)
    params = _jax_params(jr.init, 5)
    ours = rnnp.RNNP(7, elayers=2, cdim=6, hdim=5, typ=typ,
                     storage_dtype=F32, device='cpu')
    load_named(ours, params_to_named(params))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 10, 7)).astype(np.float32)
    dout = rng.standard_normal((3, 10, 5)).astype(np.float32)

    @jax.jit
    def fwd_bwd(p, x, dout):
        y, vjp = jax.vjp(lambda p: jr.apply(p, x, remat=False), p)
        return y, vjp(dout)[0]

    ref, ref_grads = fwd_bwd(params, jnp.asarray(x), jnp.asarray(dout))
    out = ours(_t(x))
    _close(out.detach(), ref, 1e-4)
    out.backward(_t(dout))
    named = dict(ours.named_parameters())
    for name, want in params_to_named(ref_grads).items():
        _close(named[name].grad, want, 1e-4)


def test_load_named_carries_gru_layers_strictly():
    jr = JaxRNNP(idim=7, elayers=2, cdim=6, hdim=5, typ='bgru')
    named = params_to_named(_jax_params(jr.init, 7))
    assert named['lstm1.weight_hh_l0_reverse'].shape == (18, 6)
    ours = rnnp.RNNP(7, elayers=2, cdim=6, hdim=5, typ='bgru',
                     storage_dtype=F32, device='cpu')
    load_named(ours, named)
    named['lstm0.weight_ih_l0'] = np.zeros((24, 7), np.float32)  # LSTM's 4H
    with pytest.raises(RuntimeError):
        load_named(ours, named)


# -- losses --------------------------------------------------------------------

class _Out:
    def __init__(self, **fields):
        self.__dict__.update(dict.fromkeys(
            ('time_estimate', 'stft_estimate', 'logit', 'vad_logit'), None))
        self.__dict__.update(fields)


def _pair(out_np, jnp_fn, torch_fn):
    return (_Out(**{k: jnp_fn(v) for k, v in out_np.items()}),
            _Out(**{k: torch_fn(v) for k, v in out_np.items()}))


def _loss_case(name, pit, masked):
    """(config, example, forward output) in numpy, B 2, S 3."""
    rng = np.random.default_rng(8)
    B, S, T, F, N = 2, 3, 9, 5, 40
    ex, out = {'reference_channel': 0}, {}
    if name in ('MSE', 'MAE', 'LogMAE'):
        cfg = {'factory': name, 'pit': pit}
        out['time_estimate'] = rng.standard_normal((B, S, N)).astype(
            np.float32)
        ex['speaker_reverberation_early_ch0'] = rng.standard_normal(
            (B, S, N)).astype(np.float32)
        if masked:
            ex['_sample_mask'] = (np.arange(N) < np.array([[N], [25]])[
                :, :, None]).astype(np.float32)
    elif name == 'FreqMSE':
        cfg = {'factory': name, 'pit': pit}
        est = rng.standard_normal((B, S, T, F)) + 1j * rng.standard_normal(
            (B, S, T, F))
        out['stft_estimate'] = est.astype(np.complex64)
        ex['Speaker_reverberation_early'] = (est + 0.3 * rng.standard_normal(
            est.shape)).astype(np.complex64)
    else:
        cfg = {'factory': name, 'pit': pit}
        out['logit'] = (2 * rng.standard_normal((B, S, 1, T, F))).astype(
            np.float32)
        ex['Vad'] = (rng.uniform(size=(B, S, T)) > 0.5).astype(np.float32)
        if name == 'SignalAndVADSigmoidBCE':
            cfg['signal_loss'] = {'factory': 'LogMAE'}
            cfg['vad_weight'], cfg['signal_weight'] = 0.7, 1.3
            out['vad_logit'] = out.pop('logit')[:, :, :, :, 0]
            out['time_estimate'] = rng.standard_normal((B, S, N)).astype(
                np.float32)
            ex['speaker_reverberation_early_ch0'] = rng.standard_normal(
                (B, S, N)).astype(np.float32)
        if masked:
            ex['_frame_mask'] = (np.arange(T) < np.array([[T], [6]])[
                :, :, None]).astype(np.float32)
    return cfg, ex, out


LOSS_CASES = [(n, pit, masked)
              for n in ('MSE', 'MAE', 'LogMAE', 'VADSigmoidBCE')
              for pit, masked in ((False, False), (True, False),
                                  (False, True))] + [
    ('FreqMSE', False, False), ('SignalAndVADSigmoidBCE', False, False)]


@pytest.mark.parametrize('name,pit,masked', LOSS_CASES)
def test_loss_matches_jax(name, pit, masked):
    cfg, ex, out = _loss_case(name, pit, masked)
    jax_cfg = dict(cfg, factory=getattr(jax_losses, name))
    if 'signal_loss' in cfg:
        jax_cfg['signal_loss'] = jax_losses.LogMAE()
    ref_loss = jax_cfg.pop('factory')(**jax_cfg)
    ours = losses.loss_from_config(cfg)
    jax_out, torch_out = _pair(out, jnp.asarray, _t)
    want = ref_loss.from_ex_out({k: (jnp.asarray(v) if isinstance(
        v, np.ndarray) else v) for k, v in ex.items()}, jax_out, None)
    got = ours.from_ex_out({k: (_t(v) if isinstance(v, np.ndarray) else v)
                            for k, v in ex.items()}, torch_out)
    assert got.shape == want.shape
    _close(got, want, 1e-5)
    assert ours.device_targets() == ref_loss.device_targets()
    assert ours.targets() == ref_loss.targets()


def test_vad_loss_derives_the_target_from_a_signal_as_jax():
    """``VADSigmoidBCE`` with a time-domain target thresholds its
    magnitude."""
    rng = np.random.default_rng(9)
    est = rng.standard_normal((2, 3, 4, 6)).astype(np.float32)
    target = rng.standard_normal((2, 3, 4, 6)).astype(np.float32)
    ours = losses.VADSigmoidBCE(target='speaker_source', pit=False)
    ref = jax_losses.VADSigmoidBCE(target='speaker_source', pit=False)
    _close(ours(_t(est), _t(target)), ref(jnp.asarray(est),
                                          jnp.asarray(target)), 1e-5)


# -- enhancers -----------------------------------------------------------------

@pytest.mark.parametrize('nmask,kwargs', [
    (1, {}), (2, {}), (1, {'diagonal_loading': 0.1}),
    (2, {'masking': True, 'masking_eps': 0.05})])
def test_souden_mvdr_matches_jax(nmask, kwargs):
    rng = np.random.default_rng(10)
    B, S, D, T, F = 2, 3, 4, 30, 9
    obs = (rng.standard_normal((B, D, T, F))
           + 1j * rng.standard_normal((B, D, T, F))).astype(np.complex64)
    masks = rng.uniform(0.05, 0.95, (B, S, nmask, T, F)).astype(np.float32)
    ref = jax_enh.SoudenMVDR(**kwargs)
    ours = enhancer.enhancer_from_config({
        'factory': 'tssep_tpu.tasks.enhancer.TorchBF', **kwargs})
    want = np.asarray(jax.jit(lambda m, o: ref(m, {
        'Observation': o, 'reference_channel': 1}, None))(
            jnp.asarray(masks), jnp.asarray(obs)))
    got = ours(_t(masks), {'Observation': _t(obs), 'reference_channel': 1})
    assert got.shape == want.shape == (B, S, T, F)
    _close_to_peak(got.real, want.real, 1e-4)
    _close_to_peak(got.imag, want.imag, 1e-4)


def test_other_enhancers_match_jax():
    rng = np.random.default_rng(11)
    obs = (rng.standard_normal((2, 3, 5, 4))
           + 1j * rng.standard_normal((2, 3, 5, 4))).astype(np.complex64)
    masks = rng.uniform(size=(2, 2, 1, 5, 4)).astype(np.float32)
    for name in ('Masking', 'Nothing'):
        want = getattr(jax_enh, name)()(jnp.asarray(masks), {
            'Observation': jnp.asarray(obs), 'reference_channel': 2}, None)
        got = enhancer.enhancer_from_config({'factory': name})(
            _t(masks), {'Observation': _t(obs), 'reference_channel': 2})
        _close(got, want, 1e-6)
    assert enhancer.enhancer_from_config({'factory': 'Dummy'})(
        _t(masks), {}) is None
    with pytest.raises(ValueError):
        enhancer.enhancer_from_config({'factory': 'NoSuchEnhancer'})


# -- optimizer options ---------------------------------------------------------

OPTIMIZERS = [
    ('Adam', dict(amsgrad=True), 1), ('Adam', dict(weight_decay=0.01), 1),
    ('SGD', dict(), 1), ('SGD', dict(momentum=0.9), 1),
    ('Adam', dict(), 2), ('SGD', dict(momentum=0.9), 2)]


@pytest.mark.parametrize('name,kwargs,k', OPTIMIZERS)
def test_optimizer_trajectory_matches_optax(name, kwargs, k):
    """Four updates on the same gradients (one clipped, norm 20 > 10)
    against the JAX package's optax chain; with k 2 ``MultiSteps`` averages
    pairs of gradients and updates on every second call."""
    rng = np.random.default_rng(12)
    shapes = [(6, 5), (5,)]
    values = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(scale * rng.standard_normal(s)).astype(np.float32)
              for s in shapes] for scale in (0.5, 8.0, 1.0, 2.0)]
    kwargs = dict(kwargs, lr=0.01)
    tx = getattr(jax_opt, name)(**kwargs).make(every_k_steps=k)
    jp = [jnp.asarray(v) for v in values]
    state = tx.init(jp)
    update = jax.jit(tx.update)
    params = [torch.nn.Parameter(_t(v)) for v in values]
    opt = getattr(optimizer, name)(**kwargs).make(params, every_k_steps=k)
    for step_grads in grads:
        updates, state = update([jnp.asarray(g) for g in step_grads],
                                state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for p, g in zip(params, step_grads):
            p.grad = _t(g)
        opt.step()
        for p, want in zip(params, jp):
            _close(p.detach(), want, 1e-6)
    assert not np.allclose(jp[0], values[0])


def test_trainer_passes_the_virtual_minibatch_size():
    params = [torch.nn.Parameter(torch.zeros(3))]

    class _Model(torch.nn.Module):
        device = torch.device('cpu')

        def __init__(self):
            super().__init__()
            self.p = params[0]

    trainer = Trainer(_Model(), optimizer.Adam(), virtual_minibatch_size=3)
    assert isinstance(trainer.optimizer, optimizer.MultiSteps)
    assert trainer.optimizer.every_k_steps == 3


# -- the two stages of the toy recipe ------------------------------------------

def _recipe_model(stage):
    """``eg.trainer.model`` of ``init_cfg_common.yaml`` with the stage's
    YAML merged over it, as loaded by ``yaml.safe_load``."""
    with open(EXP / 'init_cfg_common.yaml') as f:
        common = yaml.safe_load(f)
    with open(EXP / f'init_cfg_{stage}.yaml') as f:
        cfg = nested_merge(common, yaml.safe_load(f))
    return cfg['eg']['trainer']['model']


@pytest.mark.parametrize('stage', ['tsvad', 'tssep'])
def test_recipe_yaml_builds_in_the_port(stage):
    cfg = _recipe_model(stage)
    ours = Model.from_config(cfg, storage_dtype=F32, device='cpu')
    ref = JaxModel.new(cfg)
    assert isinstance(ours.fe, ConcatenatedSTFTFeatures)
    assert ours.fe.output_size == ref.fe.output_size == 553
    me = ours.mask_estimator
    assert (me.idim, me.odim, me.nmask, me.num_averaged_permutations,
            me.ts_vad, me.combination) == (553, 513, 1, 2, 8, 'mul')
    assert me.output_resolution == {'tsvad': 't', 'tssep': 'tf'}[stage]
    assert type(ours.loss).__name__ == type(ref.loss).__name__ == {
        'tsvad': 'VADSigmoidBCE', 'tssep': 'LogMAE'}[stage]
    assert ours.num_params() == ref.num_params()
    assert sorted(dict(ours.named_parameters())) == sorted(params_to_named(
        _jax_params(ref.init_params)))
    if stage == 'tsvad':        # host_prepare: sample vad -> frame Vad
        vad = np.random.default_rng(15).uniform(size=(8, 5376)) > 0.5
        want = ref.host_prepare({'vad': vad})['Vad']
        got = ours.host_prepare({'vad': vad})['Vad']
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _recipe_batch(model, B=2, samples=5376, seed=13):
    """B examples of 5376 samples (24 frames) and 8 speakers, with the
    frame activity ``Vad`` of a sample-domain ``vad``."""
    rng = np.random.default_rng(seed)
    S = model.mask_estimator.ts_vad
    vad = rng.uniform(size=(B, S, samples)) > 0.5
    ex = {'observation': rng.standard_normal((B, 1, samples)).astype(
              np.float32),
          'auxInput': rng.uniform(0, 1, (B, S, 513)).astype(np.float32),
          'speaker_reverberation_early_ch0': 0.3 * rng.standard_normal(
              (B, S, samples)).astype(np.float32),
          'reference_channel': 0}
    fe = model.fe
    ex['Vad'] = stft_vad(vad, fe.window_length, fe.shift, fe.fading).astype(
        np.float32)
    assert ex['Vad'].shape == (B, S, fe.num_frames(samples))
    return ex


@pytest.mark.parametrize('stage', ['tsvad', 'tssep'])
def test_recipe_stage_matches_jax(scan_unroll_1, stage):
    """Both stages at the recipe's widths (units 40, projs 42, features 553,
    2 permutation trials) on B 2, T 24: ``forward``'s masks, and
    ``loss_fn``'s loss and every parameter's gradient."""
    cfg = _recipe_model(stage)
    jm = JaxModel.new(cfg)
    params = _jax_params(jm.init_params)
    ours = Model.from_config(cfg, storage_dtype=F32, device='cpu')
    load_named(ours, params_to_named(params))
    ex = _recipe_batch(ours)
    arrays = {k: jnp.asarray(v) for k, v in ex.items()
              if isinstance(v, np.ndarray)}

    @jax.jit
    def run(p, arrays):
        batch = dict(arrays, reference_channel=0)
        return (jm.forward(p, batch).mask,
                jax.value_and_grad(jm.loss_fn, has_aux=True)(
                    p, batch, None, True))

    ref_mask, ((ref_loss, _), ref_grads) = run(params, arrays)
    torch_ex = {k: (_t(v) if isinstance(v, np.ndarray) else v)
                for k, v in ex.items()}
    _close(ours(torch_ex).mask, ref_mask, 1e-4)
    loss, aux = ours.loss_fn(torch_ex)
    loss.backward()
    assert aux['per_example_loss'].shape == (2,)
    _close(loss.item(), float(ref_loss), 1e-4)
    named = dict(ours.named_parameters())
    for name, want in params_to_named(ref_grads).items():
        _close_to_peak(named[name].grad, want, 1e-4)


def test_input_paths_of_forward():
    """A batch that brings ``Observation`` or ``Input`` gives the masks of
    one that brings ``observation``; without ``Observation`` there is no
    estimate, and only ``VADSigmoidBCE`` trains; the ``pre_net`` hook sees
    the features."""
    cfg = _recipe_model('tsvad')
    cfg['mask_estimator'].update(units=8, projs=6)
    model = Model.from_config(cfg, storage_dtype=F32, device='cpu')
    model.init_params(torch.Generator().manual_seed(0))
    ex = {k: (_t(v) if isinstance(v, np.ndarray) else v)
          for k, v in _recipe_batch(model, samples=2000).items()}
    full = model(ex)
    stft = model.fe.stft(ex['observation'])
    with_obs = model({'Observation': stft, 'auxInput': ex['auxInput'],
                      'reference_channel': 0})
    feats = model.fe.stft_to_feature(stft[:, 0])
    seen = []
    model.pre_net_hook = lambda e: seen.append(e['Input'].shape) or e
    with_input = model({'Input': feats, 'auxInput': ex['auxInput'],
                        'reference_channel': 0, 'Vad': ex['Vad']})
    assert seen == [feats.shape]
    for out in (with_obs, with_input):
        torch.testing.assert_close(out.mask, full.mask)
    assert with_obs.stft_estimate is not None
    assert with_input.stft_estimate is None
    assert with_input.time_estimate is None
    loss, _ = model.loss_fn({'Input': feats, 'auxInput': ex['auxInput'],
                             'reference_channel': 0, 'Vad': ex['Vad']})
    assert torch.isfinite(loss)
    model.loss = losses.LogMAE()
    with pytest.raises(ValueError):
        model({'Input': feats, 'auxInput': ex['auxInput'],
               'reference_channel': 0})


def test_mvdr_model_serves_two_masks(scan_unroll_1):
    """``SoudenMVDR`` makes the head twice as wide (nmask 2) and serves
    waveforms from a multichannel observation."""
    cfg = {'fe': {'size': 64, 'shift': 16},
           'enhancer': {'factory': 'tssep_tpu.tasks.enhancer.SoudenMVDR'},
           'mask_estimator': {'units': 8, 'projs': 6, 'combination': 'mul',
                              'ts_vad': 3, 'aux_net_output_size': 33}}
    ours = Model.from_config(cfg, storage_dtype=F32, device='cpu')
    ref = JaxModel.new(cfg)
    assert ours.mask_estimator.nmask == ref.mask_estimator.nmask == 2
    params = _jax_params(ref.init_params, 1)
    load_named(ours, params_to_named(params))
    rng = np.random.default_rng(14)
    ex = {'observation': rng.standard_normal((2, 4, 700)).astype(np.float32),
          'auxInput': rng.uniform(size=(2, 3, 33)).astype(np.float32),
          'reference_channel': 0}
    out = ours({k: (_t(v) if isinstance(v, np.ndarray) else v)
                for k, v in ex.items()})
    want = jax.jit(lambda p, a: ref.forward(p, dict(a, reference_channel=0)))(
        params, {k: jnp.asarray(v) for k, v in ex.items()
                 if isinstance(v, np.ndarray)})
    _close(out.mask, want.mask, 1e-4)
    _close_to_peak(out.stft_estimate.real, np.real(want.stft_estimate), 1e-4)
    assert out.time_estimate.shape == (2, 3, 700)
