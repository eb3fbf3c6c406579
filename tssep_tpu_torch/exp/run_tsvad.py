"""Toy TS-VAD recipe launcher: port of ``tssep_tpu/exp/run_tsvad.py``
(reference ``tssep/exp/run_tsvad.py``). Initializes the storage dir from
the layered configs, then trains from within it, each step a subprocess
through the port's CLI, so config dump/layering, the Makefile and resume
detection run end to end. ``flags`` go to every CLI call (``('--cpu',)``
runs on the CPU; by default the run takes the card)."""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
from pathlib import Path

_cwd = Path(__file__).parent


def run(cmd, failure='raise', cwd=None):
    printable = cmd if isinstance(cmd, str) else shlex.join(cmd)
    print(f'$ {printable}' + (f'  (cwd={cwd})' if cwd else ''))
    result = subprocess.run(cmd if isinstance(cmd, list) else ['bash', '-c', cmd],
                            cwd=cwd)
    if result.returncode != 0:
        msg = f'Command {printable} failed with return code {result.returncode}'
        if failure == 'exit':
            sys.exit(result.returncode)
        elif failure == 'raise':
            raise RuntimeError(msg)
        else:
            raise ValueError(f'Unknown failure mode {failure}')


def main(
    configs=(
        f'{_cwd}/init_cfg_common.yaml',
        f'{_cwd}/init_cfg_tsvad.yaml',
    ),
    storage_dir=f'{_cwd}/tsvad',
    failure='raise',
    flags=(),
):
    storage_dir = Path(storage_dir).resolve()
    configs = [os.fspath(Path(c).resolve()) for c in configs]

    cmd = [sys.executable, '-m', 'tssep_tpu_torch.train.run', 'init', 'with',
           *configs, f'eg.trainer.storage_dir={storage_dir}', *flags]
    if storage_dir.exists():
        print(f'VAD storage dir {storage_dir} already exists. Skipping init.')
    else:
        run(cmd, failure=failure)

    run([sys.executable, '-m', 'tssep_tpu_torch.train.run', 'with',
         'config.yaml', *flags], failure=failure, cwd=storage_dir)


if __name__ == '__main__':
    main(failure='exit')
