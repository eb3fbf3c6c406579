"""Experiment CLI: port of ``tssep_tpu/train/run.py``.

``python -m tssep_tpu_torch.train.run [command] with cfg.yaml a.b=c ...``
(sacred-style layering, last wins; reference ``tssep/train/run.py``).

Commands: ``init`` (write the storage dir: config.yaml with timestamped
backups, Makefile, python_history.txt audit log, host_info.json, log
files), ``train`` (init + run), ``makefile``, ``print_config``.

Device and storage type, on the JAX package's terms: the CLI runs on the
card unless given ``--cpu`` (the counterpart of ``JAX_PLATFORMS=cpu``) and
raises on a host without CUDA otherwise; the storage type follows
``TSSEP_COMPUTE_DTYPE`` (default float32, ``tssep_tpu/nn/estimator.py:
121-122``); the kernel switches follow ``TSSEP_PALLAS_CONDFUSE`` (default
off), ``TSSEP_PALLAS_FULLFUSE`` (on), ``TSSEP_PALLAS_SPILL`` (off) and
``TSSEP_PALLAS_BIDI`` (on), as the JAX package reads them, and the head's
type ``TSSEP_HEAD_BF16`` (default off: float32; ``tssep_tpu/nn/estimator.py:
130``). None of these is part of ``config.yaml``.

Data-parallel: with ``eg.trainer.mesh`` set, run one process a rank under
``python -m torch.distributed.run --nproc_per_node=N -m
tssep_tpu_torch.train.run ...`` (NCCL on the cards, gloo with ``--cpu``);
``init`` joins the process group first, and rank 0 alone writes the
storage dir.
"""

from __future__ import annotations

import datetime
import filecmp
import json
import os
import platform
import shlex
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import yaml

from tssep_tpu_torch.config.configurable import (
    dump_yaml, dumps_yaml, from_config, load_yaml, nested_merge, nested_set,
)
from tssep_tpu_torch.dist import multihost
from tssep_tpu_torch.train.experiment import Experiment

__all__ = ['main', 'build_config', 'init', 'train', 'runtime_options']


#: '--' flags the CLI understands; anything else is rejected loudly.
KNOWN_FLAGS = {'pdb', 'cpu'}

_STORAGE = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
#: The kernel switches: (environment variable, default), as the JAX
#: package reads them (``tssep_tpu/nn/rnnp.py:266,277,299``,
#: ``tssep_tpu/kernels/blstm.py:612``).
_SWITCHES = {'cond_fuse': ('TSSEP_PALLAS_CONDFUSE', '0'),
             'fullfuse': ('TSSEP_PALLAS_FULLFUSE', '1'),
             'spill': ('TSSEP_PALLAS_SPILL', '0'),
             'bidi': ('TSSEP_PALLAS_BIDI', '1')}


def parse_argv(argv):
    """Returns (command, config_files, overrides). '--<flag>' tokens are
    validated against KNOWN_FLAGS (callers re-scan argv for the ones they
    honor: ``--pdb``, ``--cpu``)."""
    command = 'train'
    rest = list(argv)
    if rest and rest[0] in ('init', 'train', 'makefile', 'print_config'):
        command = rest.pop(0)
    if rest and rest[0] == 'with':
        rest.pop(0)
    files, overrides = [], {}
    for token in rest:
        if token.startswith('--'):
            if token[2:] not in KNOWN_FLAGS:
                raise ValueError(
                    f'Unknown flag {token!r} (known: '
                    f'{sorted("--" + f for f in KNOWN_FLAGS)})')
        elif '=' in token and not token.endswith(('.yaml', '.yml')):
            key, _, value = token.partition('=')
            overrides[key] = yaml.safe_load(value)
        else:
            files.append(token)
    return command, files, overrides


def runtime_options(argv=(), environ=None) -> dict:
    """The port-only options of a run: ``device`` (the card, or the CPU
    with ``--cpu``), ``storage_dtype``, ``head_dtype`` and the kernel
    switches from the environment. Raises on a host without CUDA unless
    ``--cpu``."""
    environ = os.environ if environ is None else environ
    if '--cpu' in argv:
        device = torch.device('cpu')
    elif torch.cuda.is_available():
        device = torch.device('cuda')
    else:
        raise RuntimeError('CUDA is not available on this host; pass --cpu '
                           'to run on the CPU')
    dtype = environ.get('TSSEP_COMPUTE_DTYPE', 'float32')
    if dtype not in _STORAGE:
        raise ValueError(f'TSSEP_COMPUTE_DTYPE={dtype!r}: one of '
                         f'{sorted(_STORAGE)}')
    head = environ.get('TSSEP_HEAD_BF16', '0') != '0'
    return {'device': device, 'storage_dtype': _STORAGE[dtype],
            'head_dtype': torch.bfloat16 if head else torch.float32,
            **{name: environ.get(var, default) != '0'
               for name, (var, default) in _SWITCHES.items()}}


def build_config(files=(), overrides=None):
    cfg = {'eg': {'trainer': {'storage_dir': None}}}
    for f in files:
        cfg = nested_merge(cfg, load_yaml(f))
    for key, value in (overrides or {}).items():
        nested_set(cfg, key, value)

    eg_cfg = Experiment.get_config(cfg['eg'])
    if eg_cfg['trainer'].get('storage_dir') in (None, ''):
        root = Path.cwd() / 'egs' / 'extract'
        root.mkdir(parents=True, exist_ok=True)
        existing = [int(p.name) for p in root.iterdir() if p.name.isdigit()]
        eg_cfg['trainer']['storage_dir'] = str(
            root / str(max(existing, default=0) + 1))
    cfg['eg'] = eg_cfg
    return cfg


def backup_config(config_yaml: Path):
    ts = datetime.datetime.fromtimestamp(
        config_yaml.stat().st_mtime).strftime('%Y_%m_%d_%H_%M_%S')
    backup_file = (config_yaml.parent / 'backup'
                   / config_yaml.name.replace('.yaml', f'_{ts}.yaml'))
    if backup_file.exists():
        if filecmp.cmp(backup_file, config_yaml):
            return
        ts = datetime.datetime.today().strftime('%Y_%m_%d_%H_%M_%S')
        backup_file = (config_yaml.parent / 'backup'
                       / config_yaml.name.replace('.yaml', f'_{ts}.yaml'))
    backup_file.parent.mkdir(exist_ok=True)
    shutil.copy(config_yaml, backup_file)


def dump_config(storage_dir, config):
    storage_dir = Path(storage_dir)
    config_yaml = storage_dir / 'config.yaml'
    new_content = dumps_yaml(config)
    if config_yaml.exists():
        backup_config(config_yaml)
        if config_yaml.read_text() == new_content:
            return
    dump_yaml(config, config_yaml)


def write_makefile(storage_dir):
    storage_dir = Path(storage_dir)
    main_path = 'tssep_tpu_torch.train.run'
    (storage_dir / 'Makefile').write_text(f'''SHELL := /bin/bash
# FLAGS=--cpu runs on the CPU; by default the run takes the card.
FLAGS ?=

.PHONY: help init run makefile

help:
\tcat Makefile

init:
\t# Update config.yaml and Makefile. Print config.
\tpython -m {main_path} init with config.yaml $(FLAGS)

run:
\tpython -m {main_path} with config.yaml $(FLAGS)

makefile:
\t@# Update this makefile.
\tpython -m {main_path} makefile with config.yaml
''')


def run_with_pdb(fn, use_pdb):
    """sacred's ``--pdb``: run ``fn()``; on failure drop into the
    post-mortem debugger."""
    try:
        return fn()
    except Exception:
        if not use_pdb:
            raise
        import pdb
        import traceback
        traceback.print_exc()
        pdb.post_mortem()
        raise


def _nvidia_smi():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f'unavailable: {e!r}'
    return out.stdout.strip() or f'unavailable: {out.stderr.strip()}'


def host_info():
    """Environment snapshot for the storage dir (sacred host-info,
    reference ``run.py:59-68``): the host, Python, torch and CUDA, the
    process's rank and the process count, the card's name and power limit,
    and the SLURM/CUDA/TSSEP/OMP and rendezvous variables."""
    keys = [k for k in os.environ
            if k.startswith(('SLURM', 'CUDA', 'TSSEP', 'OMP', 'MASTER_',
                             'WORLD_SIZE', 'RANK', 'LOCAL_RANK'))]
    info = {
        'hostname': platform.node(),
        'platform': platform.platform(),
        'python': sys.version.split()[0],
        'torch': torch.__version__,
        'torch_cuda': torch.version.cuda,
        'argv': sys.argv,
        'cwd': str(Path.cwd()),
        'env': {k: os.environ[k] for k in sorted(keys)},
        'process_index': multihost.process_index(),
        'process_count': multihost.process_count(),
    }
    if torch.cuda.is_available():
        info['devices'] = [torch.cuda.get_device_name(i)
                           for i in range(torch.cuda.device_count())]
        info['nvidia_smi'] = _nvidia_smi()
    else:
        info['devices'] = 'no CUDA device'
    return info


def init(config, options=None):
    """Writes the storage dir and returns the ``Experiment`` built with
    ``options`` (``runtime_options``; default: the card, float32). With
    a mesh, joins the process group first, and only rank 0 writes."""
    options = options or {}
    if config['eg']['trainer'].get('mesh'):
        multihost.initialize(device=options.get('device'))
    if multihost.process_index() != 0:
        return from_config(config['eg'], **options)
    storage_dir = Path(config['eg']['trainer']['storage_dir'])
    storage_dir.mkdir(exist_ok=True, parents=True)

    with open(storage_dir / 'python_history.txt', 'a') as fd:
        print(f'{shlex.join(sys.argv)}'
              f'  # {datetime.datetime.today().strftime("%Y.%m.%d %H:%M:%S")}'
              f'  # {Path.cwd()}', file=fd)

    (storage_dir / 'host_info.json').write_text(
        json.dumps(host_info(), indent=1, default=str))

    cwd = Path.cwd()
    if cwd.parts[:-1] == storage_dir.parts[:-1]:
        assert cwd == storage_dir, (cwd, storage_dir)

    dump_config(storage_dir, config)
    print(dumps_yaml(config))
    write_makefile(storage_dir)

    eg: Experiment = from_config(config['eg'], **options)
    eg.add_log_files()
    print(f'Initialized {storage_dir}')
    return eg


def train(config, options=None):
    eg = init(config, options)
    eg.train()
    return eg


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    use_pdb = '--pdb' in argv

    def dispatch():
        command, files, overrides = parse_argv(argv)
        config = build_config(files, overrides)
        if command == 'print_config':
            print(dumps_yaml(config))
        elif command == 'makefile':
            write_makefile(config['eg']['trainer']['storage_dir'])
        elif command == 'init':
            return init(config, runtime_options(argv))
        elif command == 'train':
            return train(config, runtime_options(argv))
        else:
            raise ValueError(command)

    return run_with_pdb(dispatch, use_pdb)


if __name__ == '__main__':
    print(shlex.join(sys.argv))
    main()
