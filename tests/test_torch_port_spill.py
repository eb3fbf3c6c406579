"""The port's spill pair (``spill=True``) against ``tssep_tpu`` on the CPU.

``blstm_fullfused_spill_fwd`` / ``blstm_fullfused_spill_bwd`` replace
``_ffs_fwd_kernel`` / ``_ffs_bwd_kernel``; ``BLSTMLayerFullFusedSpill``
replaces ``blstm_layer_fullfused_spill``'s custom VJP. The JAX side runs its
Pallas kernels in the interpreter with tiny blocks (the ``kb`` fixture, as in
``tests/test_torch_port_cond.py``), the port runs the plain versions of its
kernels. Inputs are made with numpy from a seed; T is not a multiple of
``SPILL_BLOCK`` = 8, so there are several spill blocks and a short last one.
Tolerances, float32 on both sides, summed in other orders: the layer's h and
c boundaries at atol 2e-5 and every gradient (dx, the eight parameters) at
atol 1e-4, the kernel tolerances of ``tests/test_kernels.py``; the model at
atol 1e-4, each parameter gradient of ``Model.loss_fn`` at 1e-4 of that
gradient's max, against the JAX default path (``tests/test_kernels.py``
holds the JAX spill path against the scan path), except in the one test
marked ``slow``, which runs JAX's own SPILL path in the interpreter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tssep_tpu.tasks.model import Model as JaxModel
from tssep_tpu.train.checkpoint import params_to_named
from tssep_tpu_torch.compat.from_jax import load_named
from tssep_tpu_torch.kernels import blstm as port
from tssep_tpu_torch.nn import rnnp
from tssep_tpu_torch.tasks.model import Model

F32 = torch.float32
FWD_ATOL, GRAD_ATOL, MODEL_ATOL = 2e-5, 1e-4, 1e-4
F, H = 12, 16
TARGET = 'speaker_reverberation_early_ch0'


@pytest.fixture(scope='module')
def kb():
    """The JAX kernels module in interpret mode with tiny blocking, restored
    on teardown (as ``tests/test_kernels.py`` patches it)."""
    from tssep_tpu.kernels import blstm
    saved = (blstm.INTERPRET, blstm.BATCH_BLOCK, blstm.BIDI_BATCH_BLOCK,
             blstm.TIME_BLOCK)
    blstm.INTERPRET = True
    blstm.BATCH_BLOCK = 8
    blstm.BIDI_BATCH_BLOCK = 8
    blstm.TIME_BLOCK = 4
    yield blstm
    (blstm.INTERPRET, blstm.BATCH_BLOCK, blstm.BIDI_BATCH_BLOCK,
     blstm.TIME_BLOCK) = saved


def _inputs(B, T, seed):
    """x (B, T, F), one layer's params, dout (B, T, 2H)."""
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(H)
    params = {n + s: rng.uniform(-bound, bound, (4 * H,) + sh).astype(
        np.float32) for s in ('', '_reverse')
        for n, sh in (('weight_ih_l0', (F,)), ('weight_hh_l0', (H,)),
                      ('bias_ih_l0', ()), ('bias_hh_l0', ()))}
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    dout = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    return x, params, dout


def _stack(params, name):
    return torch.stack([torch.from_numpy(params[name]),
                        torch.from_numpy(params[name + '_reverse'])])


def _kernel_args(params):
    """w_ih_t (2, F, 4H), w_hh_t (2, H, 4H), bias (2, 4H), float32."""
    return (_stack(params, 'weight_ih_l0').transpose(1, 2).contiguous(),
            _stack(params, 'weight_hh_l0').transpose(1, 2).contiguous(),
            _stack(params, 'bias_ih_l0') + _stack(params, 'bias_hh_l0'))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


# B 3 and 10 pad the JAX batch to 8 and 16 rows; T 23 and 37 pad its time
# to 24 and 40 (3 and 5 spill blocks)
CASES = [(3, 23), (10, 37)]


@pytest.mark.parametrize('B,T', CASES + [(3, 37), (10, 23)])
def test_spill_fwd_plain_matches_jax(kb, B, T):
    """h against ``blstm_layer_fullfused_spill``, the c boundaries against
    ``_ffs_fwd_impl``'s, direction by direction in walk order."""
    x, params, _ = _inputs(B, T, seed=B * 100 + T)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref_h = kb.blstm_layer_fullfused_spill(jp, jnp.asarray(x))
    xs, xr, wihf, wihr, bf, br, wf, wr, _, _ = kb._ffs_prep(
        jnp.asarray(x), jp)
    _, _, cbf, cbr = kb._ffs_fwd_impl(xs, xr, wihf, wihr, bf, br, wf, wr)

    h, cb = port.blstm_fullfused_spill_fwd_plain(
        torch.from_numpy(x), *_kernel_args(params), with_boundaries=True)
    assert h.shape == (B, T, 2 * H)
    assert cb.shape == (2, -(-T // port.SPILL_BLOCK), B, H)
    _close(h, ref_h, FWD_ATOL)
    _close(cb[0], np.asarray(cbf)[:, :B], FWD_ATOL)
    _close(cb[1], np.asarray(cbr)[:, :B], FWD_ATOL)
    assert not cb[:, 0].any()
    # the same h as the fully fused layer's, which saves c instead
    h_ff, _ = port.blstm_fullfused_fwd_plain(torch.from_numpy(x),
                                             *_kernel_args(params))
    torch.testing.assert_close(h, h_ff, atol=0, rtol=0)


@pytest.mark.parametrize('B,T', CASES)
def test_spill_function_matches_jax_vjp(kb, B, T):
    """dx and all eight parameter gradients of ``BLSTMLayerFullFusedSpill``
    against ``jax.vjp`` of ``blstm_layer_fullfused_spill``, whose backward
    runs ``_ffs_bwd_kernel`` in the interpreter."""
    x, params, dout = _inputs(B, T, seed=B * 100 + T)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref, vjp = jax.vjp(kb.blstm_layer_fullfused_spill, jp, jnp.asarray(x))
    ref_params, ref_dx = vjp(jnp.asarray(dout))

    x_t = torch.from_numpy(x).requires_grad_()
    tensors = {n: torch.from_numpy(params[n]).requires_grad_()
               for n in rnnp.PARAM_NAMES}
    h = rnnp.BLSTMLayerFullFusedSpill.apply(x_t, *tensors.values(), F32)
    assert type(h.grad_fn).__name__ == 'BLSTMLayerFullFusedSpillBackward'
    _close(h.detach(), ref, FWD_ATOL)
    h.backward(torch.from_numpy(dout))
    _close(x_t.grad, ref_dx, GRAD_ATOL)
    assert sorted(ref_params) == sorted(tensors)
    for name, value in ref_params.items():
        _close(tensors[name].grad, value, GRAD_ATOL)


def test_spill_bwd_plain_matches_fullfused_bwd_in_float32():
    """In float32 the c the spill backward rebuilds is the c the fully fused
    forward saved (no rounding at the boundaries), so both backward plain
    versions give the same gradients up to the order of the sums."""
    x, params, dout = _inputs(4, 19, seed=7)
    x = torch.from_numpy(x)
    args = _kernel_args(params)
    h, c = port.blstm_fullfused_fwd_plain(x, *args, with_cell=True)
    _, cb = port.blstm_fullfused_spill_fwd_plain(x, *args,
                                                 with_boundaries=True)
    dh = torch.from_numpy(dout)
    got = port.blstm_fullfused_spill_bwd_plain(x, *args, h, cb, dh)
    want = port.blstm_fullfused_bwd_plain(x, *args, h, c, dh)
    for g, w in zip(got, want):
        _close(g, w, GRAD_ATOL)


def test_spill_gradients_stay_float32_in_bf16_storage():
    """With bf16 storage the Function takes float32 master weights and
    returns float32 gradients for all eight parameters; dx comes back in
    x's dtype."""
    x, params, dout = _inputs(2, 11, seed=0)
    x_t = torch.from_numpy(x).requires_grad_()
    tensors = [torch.from_numpy(params[n]).requires_grad_()
               for n in rnnp.PARAM_NAMES]
    h = rnnp.BLSTMLayerFullFusedSpill.apply(x_t, *tensors, torch.bfloat16)
    assert h.dtype == torch.bfloat16
    h.float().backward(torch.from_numpy(dout))
    assert x_t.grad.dtype == F32
    assert all(t.grad.dtype == F32 for t in tensors)


def test_spill_wrappers_reject_what_no_kernel_takes():
    B, T = 2, 11
    x = torch.zeros(B, T, F)
    w_ih_t, w_hh_t = torch.zeros(2, F, 4 * H), torch.zeros(2, H, 4 * H)
    bias, seq = torch.zeros(2, 4 * H), torch.zeros(B, T, 2 * H)
    cb = torch.zeros(2, 2, B, H)
    with pytest.raises(ValueError, match='no kernel for device'):
        port.blstm_fullfused_spill_fwd(*(t.to('meta') for t in (
            x, w_ih_t, w_hh_t, bias)))
    with pytest.raises(ValueError, match='no kernel for device'):
        port.blstm_fullfused_spill_bwd(*(t.to('meta') for t in (
            x, w_ih_t, w_hh_t, bias, seq, cb, seq)))
    with pytest.raises(ValueError, match='expected shape'):
        port.blstm_fullfused_spill_bwd(x, w_ih_t, w_hh_t, bias, seq,
                                       cb[:, :1], seq)
    with pytest.raises(ValueError, match='expected torch.float32'):
        port.blstm_fullfused_spill_bwd(x, w_ih_t, w_hh_t, bias, seq,
                                       cb.bfloat16(), seq)


# -- the model ---------------------------------------------------------------

@pytest.fixture
def scan_unroll_1():
    """The JAX scan path with one step per scan iteration: the same
    arithmetic as its default of 8, compiled in a fraction of the time."""
    from tssep_tpu.nn import rnnp as jax_rnnp
    saved = jax_rnnp.DEFAULT_UNROLL
    jax_rnnp.DEFAULT_UNROLL = 1
    yield
    jax_rnnp.DEFAULT_UNROLL = saved


def _small_config(combination='mul', ts_vad=3, layers=3):
    """The small 'mul' configuration of ``tests/test_torch_port_cond.py``."""
    return {
        'fe': {'size': 64, 'shift': 16, 'window': 'hann'},
        'mask_estimator': {
            'units': 16, 'projs': 12, 'combination': combination,
            'ts_vad': ts_vad, 'layers': layers,
            'aux_net_output_size': 33 if combination == 'mul' else 20,
            'output_resolution': 'tf',
        },
    }


def _batch(B, S_, A, samples=600, seed=3):
    rng = np.random.default_rng(seed)
    return {'observation': rng.standard_normal((B, 1, samples)).astype(
                np.float32),
            'auxInput': rng.uniform(0, 1, (B, S_, A)).astype(np.float32),
            TARGET: 0.3 * rng.standard_normal((B, S_, samples)).astype(
                np.float32),
            'reference_channel': 0}


def _torch_batch(ex):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in ex.items()}


def _both(cfg, **switches):
    jm = JaxModel.new(cfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    ours = Model.from_config(cfg, storage_dtype=F32, device='cpu',
                             **switches)
    load_named(ours, params_to_named(params))
    return jm, params, ours


def _jax_served(jm, params, ex):
    """Masks, logits and waveforms of the JAX model's default path on
    ``ex``, jitted (the same numbers as op by op, in a fraction of the
    time)."""
    samples = ex['observation'].shape[-1]

    @jax.jit
    def served(p, arrays):
        out = jm.forward(p, dict(arrays, reference_channel=0), rng=None)
        return out.mask, out.logit, jm.fe.istft(out.stft_estimate,
                                                num_samples=samples)

    return served(params, {k: jnp.asarray(v) for k, v in ex.items()
                           if isinstance(v, np.ndarray) and k != TARGET})


def test_spill_forward_matches_jax(scan_unroll_1):
    """Served masks, logits and waveforms with ``spill`` against the JAX
    default path: the spill forward computes the fully fused layer's h."""
    jm, params, ours = _both(_small_config(), spill=True)
    ex = _batch(2, 3, 33)
    mask, logit, wave = _jax_served(jm, params, ex)
    out = ours(_torch_batch(ex))
    assert out.mask.shape == mask.shape
    _close(out.mask, mask, MODEL_ATOL)
    _close(out.logit, logit, MODEL_ATOL)
    _close(out.time_estimate, wave, MODEL_ATOL)


def test_spill_loss_fn_and_gradients_match_jax(scan_unroll_1):
    """The training step with ``spill`` (with ``cond_fuse`` and ``bidi=False``
    too in ``tests/test_torch_port_uni.py``) against the JAX default path."""
    cfg = _small_config()
    jm, params, ours = _both(cfg, spill=True)
    ex = _batch(2, 3, 33)

    @jax.jit
    def value_and_grad(p, arrays):
        return jax.value_and_grad(jm.loss_fn, has_aux=True)(
            p, dict(arrays, reference_channel=0), None, True)

    (ref_loss, _), ref_grads = value_and_grad(
        params, {k: jnp.asarray(v) for k, v in ex.items()
                 if isinstance(v, np.ndarray)})
    loss, _ = ours.loss_fn(_torch_batch(ex))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=MODEL_ATOL,
                               rtol=0)
    named = dict(ours.named_parameters())
    ref_named = params_to_named(ref_grads)
    assert sorted(named) == sorted(ref_named)
    for name, want in ref_named.items():
        want = np.asarray(want)
        err = np.abs(named[name].grad.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)


def _counting(monkeypatch, names):
    """Counts the calls ``nn/rnnp.py`` makes to the named kernel wrappers."""
    counts = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(rnnp, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            counts[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(rnnp, name, counted)
    return counts


KERNELS = ('blstm_fullfused_spill_fwd', 'blstm_fullfused_spill_bwd',
           'blstm_fullfused_cond_fwd', 'blstm_fullfused_cond_bwd',
           'blstm_fullfused_fwd', 'blstm_fullfused_bwd', 'blstm_bidi_fwd',
           'blstm_bidi_bwd', 'lstm_fwd', 'lstm_bwd')


@pytest.mark.parametrize('switches,want', [
    # every fully fused layer spills; the wide stacked birnn2 does not
    (dict(spill=True), dict(spill=3, bidi=1)),
    # the conditioned birnn0 does not spill
    (dict(spill=True, cond_fuse=True), dict(cond=1, spill=2, bidi=1)),
    # nothing is fully fused, so nothing spills
    (dict(spill=True, fullfuse=False), dict(bidi=4)),
    (dict(spill=True, bidi=False), dict(spill=3, lstm=2)),
])
def test_dispatch_picks_the_spill_layers(monkeypatch, switches, want):
    """Which kernels a served request and a training step run, by layer
    count (``lstm`` counts directions); the backward runs as many as the
    forward. The fully fused width limit is cut to 33 so that the small
    model's layers split as the flagship's do: ``pre_net``, ``birnn0`` (33
    wide) and ``birnn1`` (12) fully fused, the stacked ``birnn2`` (36) not."""
    monkeypatch.setattr(rnnp, 'FULLFUSE_MAX_INPUT', 33)
    model = Model.from_config(_small_config(), storage_dtype=F32,
                              device='cpu', **switches)
    model.init_params(torch.Generator().manual_seed(0))
    counts = _counting(monkeypatch, KERNELS)
    ex = _torch_batch(_batch(1, 3, 33, samples=400))
    model(ex)
    served = dict(counts)
    loss, _ = model.loss_fn(ex)
    loss.backward()
    step = {k: counts[k] - served[k] for k in KERNELS}
    names = {'spill': 'blstm_fullfused_spill_fwd',
             'cond': 'blstm_fullfused_cond_fwd',
             'fullfused': 'blstm_fullfused_fwd', 'bidi': 'blstm_bidi_fwd',
             'lstm': 'lstm_fwd'}
    expect = {fwd: want.get(key, 0) for key, fwd in names.items()}
    assert {k: served[k] for k in expect} == expect
    assert all(served[k] == 0 for k in KERNELS if k.endswith('_bwd'))
    for fwd, n in expect.items():
        assert step[fwd] == step[fwd.replace('_fwd', '_bwd')] == n, step


@pytest.mark.slow
def test_spill_matches_jax_spill_path(kb, monkeypatch, scan_unroll_1):
    """The port's spill path against JAX's own (``SPILL`` on, every layer
    through its Pallas kernels in the interpreter): served masks and the
    training step's gradients."""
    from tssep_tpu.nn import rnnp as jax_rnnp
    monkeypatch.setattr(jax_rnnp, 'SPILL', True)
    monkeypatch.setattr(jax_rnnp, '_FORCED_IMPL', 'pallas')
    cfg = _small_config()
    jm, params, ours = _both(cfg, spill=True)
    ex = _batch(2, 3, 33)
    ref = jm.forward(params, {k: jnp.asarray(v) for k, v in ex.items()
                              if k != TARGET}, rng=None)
    out = ours(_torch_batch(ex))
    _close(out.mask, ref.mask, MODEL_ATOL)
    _close(out.logit, ref.logit, MODEL_ATOL)

    (ref_loss, _), ref_grads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        params, {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                 for k, v in ex.items()}, None, True)
    loss, _ = ours.loss_fn(_torch_batch(ex))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=MODEL_ATOL,
                               rtol=0)
    named = dict(ours.named_parameters())
    for name, want in params_to_named(ref_grads).items():
        want = np.asarray(want)
        err = np.abs(named[name].grad.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)
