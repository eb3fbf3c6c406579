"""Run the R5W record through the port's launcher on the card, each output
line stamped with the seconds since the start.

    python3 tools/r5w_port.py [work_dir [log_dir]] [--key=value ...]

runs ``python -m tssep_tpu_torch.exp.run_simulated <work_dir> --multichannel
--vocabulary=8 --eval_examples=8 [--key=value ...]`` (default work dir
``build/r5w_port``, which git ignores), prints the card's name and power
limit first, writes the stamped log to ``<log_dir>/r5w.log`` (default
``build/r5w_log``) and copies the stages' ``config.yaml``,
``metrics.jsonl`` and every ``metrics.json`` there. Exits with the
recipe's exit code.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import time
from pathlib import Path


def main(argv):
    positional = [a for a in argv if not a.startswith('-')]
    work = Path(positional[0] if positional else 'build/r5w_port')
    out = Path(positional[1] if len(positional) > 1 else 'build/r5w_log')
    flags = [a for a in argv if a.startswith('-')]
    out.mkdir(parents=True, exist_ok=True)
    try:
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True).stdout
    except OSError as e:                    # a host without the driver
        card = f'nvidia-smi unavailable: {e}'
    cmd = [sys.executable, '-u', '-m', 'tssep_tpu_torch.exp.run_simulated',
           str(work), '--multichannel', '--vocabulary=8', '--eval_examples=8',
           *flags]
    t0 = time.time()
    with open(out / 'r5w.log', 'w') as log:
        for line in (f'card: {card.strip()}', '$ ' + ' '.join(cmd)):
            print(line, file=log, flush=True)
            print(line, flush=True)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            stamped = f'[{time.time() - t0:9.2f}] {line.rstrip()}'
            print(stamped, file=log, flush=True)
            if not line.startswith('{"example_id"'):    # per recording
                print(stamped, flush=True)
        rc = proc.wait()
        end = f'EXIT {rc} after {time.time() - t0:.1f} s'
        print(end, file=log, flush=True)
    print(end, flush=True)
    for f in work.rglob('*'):
        if f.name in ('metrics.json', 'metrics.jsonl', 'config.yaml'):
            dst = out / f.relative_to(work)
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(f, dst)
    return rc


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
