"""Print digests of the port's served outputs, to compare two checkouts of
``tssep_tpu_torch`` bit for bit on one CUDA card.

Run from the root of the checkout to digest, e.g. from an unpacked parent
commit and from the working tree in turn::

    python3 path/to/tools/served_digest.py

It builds that checkout's kernels, serves the first request of
``chip_smoke.py`` (the flagship model with random weights from seed 0, a
request of batch 16 from seed 1) with the default kernel switches, in
bf16 and in f32 storage, and prints the SHA-256 of the masks and of the
waveforms. Equal digests mean bit-identical outputs.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

sys.dont_write_bytecode = True        # write nothing into the checkout
sys.path.insert(0, str(Path.cwd()))   # the checkout run from, not this one's

import torch  # noqa: E402

from chip_smoke import _flagship, _requests  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print('served_digest: CUDA is not available', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, request, *_ = _requests()
    for dtype in (torch.bfloat16, torch.float32):
        out = _flagship(dtype)(request)
        for name in ('mask', 'time_estimate'):
            data = getattr(out, name).float().cpu().numpy().tobytes()
            print(f'{dtype} {name} {hashlib.sha256(data).hexdigest()}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
