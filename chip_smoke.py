"""Drive the PyTorch port (``tssep_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each of which must pass:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: the CUDA kernels, one ``nvcc`` call into ``build/``, with
   ``-Xptxas -v``'s registers and shared memory;
3. kernels: each kernel against its plain PyTorch version on the card, at a
   ragged small shape, at the shapes of a served request (batch 16) and at
   the flagship training shapes (batch 256), in float32 and in bfloat16
   storage, with max error, kernel time, plain time and bound;
4. serving: the flagship TS-SEP model (``bench.py:98-106``, random weights
   from a seed) answers 3 requests of batch 16 through the kernels, which the
   launch counters prove, and its masks and waveforms agree with the same
   model run through the plain versions.

The last two lines of standard output are the kernels' JSON line and the
device's JSON line. Without CUDA it exits with code 1 and prints no result.
"""

from __future__ import annotations

import sys

sys.dont_write_bytecode = True        # write nothing into the checkout

import json        # noqa: E402
import subprocess  # noqa: E402
import time        # noqa: E402
from unittest import mock  # noqa: E402

import torch  # noqa: E402

from tssep_tpu_torch.kernels import _build  # noqa: E402
from tssep_tpu_torch.kernels import blstm as kb  # noqa: E402
from tssep_tpu_torch.nn import rnnp  # noqa: E402
from tssep_tpu_torch.tasks.model import Model  # noqa: E402

FLAGSHIP = {
    'fe': {'size': 1024, 'shift': 256, 'window': 'hann'},
    'reader': {'aux_size': 513},
    'mask_estimator': {
        'units': 300, 'projs': 320, 'combination': 'mul', 'ts_vad': 8,
        'aux_net_output_size': 513, 'num_averaged_permutations': 1,
        'output_resolution': 'tf',
    },
}
SAMPLES, FRAMES, BINS, SPEAKERS, HIDDEN = 80_000, 316, 513, 8, 300
SERVE_BATCH, REQUESTS = 16, 3

BF16, F32 = torch.bfloat16, torch.float32
#: Kernel against plain version, max abs error of h and c (|h| < 1). float32:
#: the same f32 sums in another order, through 316 steps. bfloat16: h is
#: rounded to bf16 before each recurrent product, so a sum order that differs
#: in the last f32 bit flips a rounding now and then; each flip is one bf16
#: ulp (2^-8 below 1) and echoes through the following steps.
KERNEL_ATOL = {F32: 1e-4, BF16: 3e-2}
#: Served masks (in [0, 1]) and waveforms (relative to their peak), kernels
#: against plain versions, through four BLSTM layers and three projections.
SERVE_ATOL = {F32: 1e-4, BF16: 5e-2}

#: H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores, f32 outside
#: the tensor cores, and HBM3.
PEAK_FLOPS = {BF16: 989e12, F32: 67e12}
PEAK_BYTES = 3.35e12

SOURCES = {
    'blstm_fullfused_fwd': ('tssep_tpu_torch/kernels/csrc/'
                            'blstm_fullfused_fwd.cu',
                            'tssep_tpu/kernels/blstm.py:797'),
    'blstm_bidi_fwd': ('tssep_tpu_torch/kernels/csrc/blstm_bidi_fwd.cu',
                       'tssep_tpu/kernels/blstm.py:374'),
}
#: (label, B, T, F, H) of the fully fused kernel's calls and (label, B, T, H)
#: of the bidi kernel's. The 'serve' rows are one request of batch 16, the
#: others the flagship training shapes at batch 256.
FULLFUSED_CASES = [('ragged', 13, 23, 12, 16),
                   ('serve pre_net', 16, FRAMES, BINS, HIDDEN),
                   ('serve birnn0', 16 * SPEAKERS, FRAMES, BINS, HIDDEN),
                   ('serve birnn1', 16 * SPEAKERS, FRAMES, 320, HIDDEN),
                   ('pre_net', 256, FRAMES, BINS, HIDDEN),
                   ('birnn0', 256 * SPEAKERS, FRAMES, BINS, HIDDEN),
                   ('birnn1', 256 * SPEAKERS, FRAMES, 320, HIDDEN)]
BIDI_CASES = [('ragged', 13, 23, 16),
              ('serve birnn2', 16, FRAMES, HIDDEN),
              ('birnn2', 256, FRAMES, HIDDEN)]


def log(*args):
    print(*args, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f'check failed: {what}')


def cuda_ms(fn, reps=3):
    """Mean time of ``fn`` over ``reps`` runs by CUDA events, after one
    warm-up run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes, dtype):
    """Least time in ms: operations over the peak for the storage type, or
    bytes (each input read once, each output written once) over HBM."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes')


def phase_device():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f'card: {out}')
    check(torch.cuda.device_count() >= 1, 'a CUDA device')


def phase_build():
    result = _build.build()
    log(f'build: one nvcc call, {result.seconds:.1f} s -> {result.path.name}')
    for line in result.log.splitlines():
        if line.strip():
            log(f'  {line.strip()}')
    _build.library()


def _uniform(gen, shape, bound_, dtype):
    draw = torch.rand(shape, generator=gen, device='cuda')
    return ((2 * draw - 1) * bound_).to(dtype)


def _max_err(got, want):
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def _case(name, dtype, run, run_plain, outputs, plain_outputs, flops,
          nbytes, library=None):
    err = _max_err(outputs, plain_outputs)
    check(err <= KERNEL_ATOL[dtype],
          f'{name} max abs error {err:.3g} > {KERNEL_ATOL[dtype]}')
    ms = cuda_ms(run)
    plain_ms = cuda_ms(run_plain, reps=1)
    library_ms = None
    if library is not None:
        try:
            library_ms = cuda_ms(library)
        except RuntimeError as exc:   # a yardstick only: record its absence
            log(f'{name}: library call refused: {exc}')
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    return {'name': name, 'dtype': str(dtype).split('.')[-1],
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': library_ms}


def fullfused_case(label, B, T, F, H, dtype, gen):
    size = torch.finfo(dtype).bits // 8
    x = torch.randn(B, T, F, generator=gen, device='cuda').to(dtype)
    b = 1 / H ** 0.5
    w_ih_t = _uniform(gen, (2, F, 4 * H), b, dtype)
    w_hh_t = _uniform(gen, (2, H, 4 * H), b, dtype)
    bias = _uniform(gen, (2, 4 * H), 2 * b, F32)
    got = kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias, with_cell=True)
    want = kb.blstm_fullfused_fwd_plain(x, w_ih_t, w_hh_t, bias,
                                        with_cell=True)
    lstm = torch.nn.LSTM(F, H, bidirectional=True, batch_first=True,
                         device='cuda', dtype=dtype)
    lstm.flatten_parameters()
    return _case(
        f'blstm_fullfused_fwd {label} B={B} T={T} F={F} H={H}', dtype,
        lambda: kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias),
        lambda: kb.blstm_fullfused_fwd_plain(x, w_ih_t, w_hh_t, bias),
        got, want, flops=2 * B * T * 2 * (F + H) * 4 * H,
        nbytes=size * (B * T * F + 2 * (F + H) * 4 * H + B * T * 2 * H)
        + 4 * 2 * 4 * H,
        library=lambda: lstm(x))


def bidi_case(label, B, T, H, dtype, gen):
    size = torch.finfo(dtype).bits // 8
    xg = torch.randn(B, T, 8 * H, generator=gen, device='cuda').to(dtype)
    w_hh_t = _uniform(gen, (2, H, 4 * H), 1 / H ** 0.5, dtype)
    got = kb.blstm_bidi_fwd(xg, w_hh_t, with_cell=True)
    want = kb.blstm_bidi_fwd_plain(xg, w_hh_t, with_cell=True)
    return _case(
        f'blstm_bidi_fwd {label} B={B} T={T} H={H}', dtype,
        lambda: kb.blstm_bidi_fwd(xg, w_hh_t),
        lambda: kb.blstm_bidi_fwd_plain(xg, w_hh_t),
        got, want, flops=2 * B * T * 2 * H * 4 * H,
        nbytes=size * (B * T * 8 * H + 2 * H * 4 * H + B * T * 2 * H))


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)
    rows = {'blstm_fullfused_fwd': [], 'blstm_bidi_fwd': []}
    with torch.no_grad():
        for dtype in (F32, BF16):
            for case in FULLFUSED_CASES:
                rows['blstm_fullfused_fwd'].append(
                    fullfused_case(*case, dtype, gen))
                log(json.dumps(rows['blstm_fullfused_fwd'][-1]))
            for case in BIDI_CASES:
                rows['blstm_bidi_fwd'].append(bidi_case(*case, dtype, gen))
                log(json.dumps(rows['blstm_bidi_fwd'][-1]))
    return rows


def make_request(gen, batch):
    """One request in ``DeviceMeetingSimulator.generate``'s layout."""
    return {
        'observation': 0.1 * torch.randn(batch, 1, SAMPLES, generator=gen,
                                         device='cuda'),
        'auxInput': torch.rand(batch, SPEAKERS, BINS, generator=gen,
                               device='cuda'),
        'reference_channel': 0,
    }


def _plain_forward(model, ex):
    with mock.patch.multiple(rnnp,
                             blstm_fullfused_fwd=kb.blstm_fullfused_fwd_plain,
                             blstm_bidi_fwd=kb.blstm_bidi_fwd_plain):
        return model(ex)


def _agreement(model, ex, dtype):
    got, want = model(ex), _plain_forward(model, ex)
    mask_err = (got.mask - want.mask).abs().max().item()
    peak = want.time_estimate.abs().max().item()
    wave_err = (got.time_estimate - want.time_estimate).abs().max().item() / peak
    log(f'serve {dtype}: kernels against plain versions: mask max abs err '
        f'{mask_err:.3g}, waveform max abs err / peak {wave_err:.3g} '
        f'(tolerance {SERVE_ATOL[dtype]})')
    check(mask_err <= SERVE_ATOL[dtype], f'{dtype} served masks')
    check(wave_err <= SERVE_ATOL[dtype], f'{dtype} served waveforms')


def phase_serving():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = Model.from_config(FLAGSHIP, storage_dtype=BF16, device='cuda')
    model.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator(device='cuda').manual_seed(1)
    warm, *requests = [make_request(gen, SERVE_BATCH)
                       for _ in range(1 + REQUESTS)]
    model(warm)
    torch.cuda.synchronize()

    kb.blstm_fullfused_fwd.launches = 0
    kb.blstm_bidi_fwd.launches = 0
    times = []
    for ex in requests:
        t0 = time.perf_counter()
        out = model(ex)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        check(out.mask.shape == (SERVE_BATCH, SPEAKERS, 1, FRAMES, BINS),
              f'mask shape {tuple(out.mask.shape)}')
        check(out.time_estimate.shape == (SERVE_BATCH, SPEAKERS, SAMPLES),
              f'waveform shape {tuple(out.time_estimate.shape)}')
        check(bool(torch.isfinite(out.mask).all()), 'finite masks')
        check(bool(torch.isfinite(out.time_estimate).all()),
              'finite waveforms')
    launches = {'blstm_fullfused_fwd': kb.blstm_fullfused_fwd.launches,
                'blstm_bidi_fwd': kb.blstm_bidi_fwd.launches}
    log(f'serve: {REQUESTS} requests of batch {SERVE_BATCH}, ms each '
        f'{[round(t, 2) for t in times]}, launches {launches}')
    check(launches == {'blstm_fullfused_fwd': 3 * REQUESTS,
                       'blstm_bidi_fwd': REQUESTS},
          f'3 fully fused and 1 bidi launch per request, got {launches}')

    _agreement(model, requests[0], BF16)
    model32 = Model.from_config(FLAGSHIP, storage_dtype=F32, device='cuda')
    model32.load_state_dict(model.state_dict())
    _agreement(model32, requests[0], F32)
    return launches


def kernels_line(rows, launches):
    """Per kernel: the numbers of one served request (the 'serve' shapes,
    bfloat16 storage), summed over its calls, and every call measured."""
    kernels = []
    for name, calls in rows.items():
        serve = [r for r in calls if ' serve ' in r['name']
                 and r['dtype'] == 'bfloat16']
        top = max(serve, key=lambda r: r['bound_ms'])
        lib = [r['library_ms'] for r in serve]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': SOURCES[name][0],
            'replaces': SOURCES[name][1], 'launches': launches[name],
            'max_abs_err': max(r['max_abs_err'] for r in serve),
            'ms': sum(r['ms'] for r in serve),
            'plain_ms': sum(r['plain_ms'] for r in serve),
            'bound_ms': sum(r['bound_ms'] for r in serve),
            'bound_by': top['bound_by'],
            'library_ms': None if None in lib else sum(lib),
            'calls': calls,
        })
    return {'kernels': kernels}


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    log(f'-- build done at {time.perf_counter() - t0:.1f} s')
    rows = phase_kernels()
    log(f'-- kernels done at {time.perf_counter() - t0:.1f} s')
    launches = phase_serving()
    log(f'-- serving done at {time.perf_counter() - t0:.1f} s')
    print(json.dumps(kernels_line(rows, launches)))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
