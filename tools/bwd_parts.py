"""Print the launch times of the port's bf16 gate-input and fully fused
backward kernels, to compare two checkouts of ``tssep_tpu_torch`` on one
CUDA card.

Run from the root of the checkout to time, e.g. from an unpacked parent
commit and from the working tree in turn (parent, change, change, parent)::

    python3 path/to/tools/bwd_parts.py

It builds that checkout's kernels and times, between CUDA events
(``chip_smoke.py``'s ``_parts_ms``), each launch of the fully fused
backward at the training shapes of batch 16 (``pre_net`` 16 rows, F 513;
``birnn0`` 128 rows, F 513), of the bidi backward at birnn2's 16 rows and,
where the checkout has its clustered route, of the one-direction backward
at 16 rows, T 316, H 300, with inputs from seed 0. It prints the card and
one JSON line of ms by kernel and launch.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.dont_write_bytecode = True        # write nothing into the checkout
sys.path.insert(0, str(Path.cwd()))   # the checkout run from, not this one's

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tssep_tpu_torch.kernels import blstm as kb  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print('bwd_parts: CUDA is not available', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device='cuda').manual_seed(0)
    bf16, T, H = torch.bfloat16, cs.FRAMES, cs.HIDDEN
    out = {}
    for label, B in (('pre_net', 16), ('birnn0', 128)):
        x, w_ih_t, w_hh_t, bias = cs._fullfused_inputs(B, T, cs.BINS, H, bf16,
                                                       gen)
        h, c = kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias, with_cell=True)
        dh = (0.1 * torch.randn(B, T, 2 * H, generator=gen,
                                device='cuda')).to(bf16)
        out[f'blstm_fullfused_bwd {label}'] = cs._bwd_parts_ms(
            (x, w_ih_t, w_hh_t, bias, h, c, dh))
    xg = torch.randn(16, T, 8 * H, generator=gen, device='cuda').to(bf16)
    w_hh_t = cs._uniform(gen, (2, H, 4 * H), H ** -0.5, bf16)
    h, c = kb.blstm_bidi_fwd(xg, w_hh_t, with_cell=True)
    dh = 0.1 * torch.randn(16, T, 2 * H, generator=gen, device='cuda')
    out['blstm_bidi_bwd birnn2'] = cs._bidi_bwd_parts_ms(
        (xg, w_hh_t, h, c, dh))
    if hasattr(kb, '_lstm_bwd_cluster'):
        args = (xg[..., :4 * H], w_hh_t[0], h[..., :H].contiguous(),
                c[..., :H].contiguous(), dh[..., :H])
        buffers = kb._lstm_bwd_buffers(xg, H)
        out['lstm_bwd birnn2'] = cs._parts_ms(
            lambda bits: kb._lstm_bwd_cluster(*args, False, parts=bits,
                                              out=buffers),
            kb.LSTM_BWD_PARTS)
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
