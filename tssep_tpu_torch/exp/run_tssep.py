"""Toy TS-SEP recipe launcher: port of ``tssep_tpu/exp/run_tssep.py``
(reference ``tssep/exp/run_tssep.py``). The same two-step CLI flow as the
TS-VAD launcher, plus the warm-start checkpoint override pointing at the
TS-VAD best checkpoint (VAD->SEP head broadcast)."""

from __future__ import annotations

import os
import sys
from pathlib import Path

from tssep_tpu_torch.exp.run_tsvad import run

_cwd = Path(__file__).parent


def main(
    configs=(
        f'{_cwd}/init_cfg_common.yaml',
        f'{_cwd}/init_cfg_tssep.yaml',
    ),
    storage_dir=f'{_cwd}/tssep',
    checkpoint=f'{_cwd}/tsvad/checkpoints/ckpt_best_loss.npz',
    failure='raise',
    flags=(),
):
    storage_dir = Path(storage_dir).resolve()
    checkpoint = Path(checkpoint).resolve()
    configs = [os.fspath(Path(c).resolve()) for c in configs]

    cmd = [sys.executable, '-m', 'tssep_tpu_torch.train.run', 'init', 'with',
           *configs, f'eg.trainer.storage_dir={storage_dir}',
           f'eg.init_ckpt.init_ckpt={checkpoint}', *flags]
    if (storage_dir / 'config.yaml').exists():
        print(f'SEP storage dir {storage_dir} already exists. Skipping init.')
    else:
        run(cmd, failure=failure)

    run([sys.executable, '-m', 'tssep_tpu_torch.train.run', 'with',
         'config.yaml', *flags], failure=failure, cwd=storage_dir)


if __name__ == '__main__':
    main(failure='exit')
