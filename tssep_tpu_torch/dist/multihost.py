"""Multi-process runtime: port of ``tssep_tpu/dist/multihost.py`` on
``torch.distributed``.

- ``initialize()`` joins the process group from torch's rendezvous
  environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
  as ``python -m torch.distributed.run`` sets them), where the JAX package
  reads the TPU pod's; the backend is NCCL on the card and gloo on the CPU
  unless the caller names one;
- each process's input pipeline yields its *local* rows of the global batch
  (``host_shard_dataset``: examples dealt round-robin by rank after the
  seed-deterministic shuffle, then batched), and its step runs on them on
  its own device; the gradients are all-reduced by the trainer;
- ``all_reduce``, ``all_gather``, ``all_gather_object`` and ``broadcast``
  are the collectives the port issues, on tensors of the backend's device,
  and ``all_reduce_host`` the numpy form for the calibration's counts.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from tssep_tpu_torch.dist.mesh import DATA_AXIS, Mesh

__all__ = ['initialize', 'is_initialized', 'process_count', 'process_index',
           'global_batch_from_local', 'host_shard_dataset', 'backend',
           'all_reduce', 'all_gather', 'all_gather_object', 'broadcast',
           'all_reduce_host', 'default_backend']

_initialized = False


def _dist():
    return torch.distributed


def _group_up():
    return _dist().is_available() and _dist().is_initialized()


def default_backend(device=None) -> str:
    """'nccl' for the card (the default device), 'gloo' for the CPU."""
    device = torch.device('cuda' if device is None else device)
    return 'nccl' if device.type == 'cuda' else 'gloo'


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None, device=None, timeout=None):
    """Joins the process group (a no-op in one process, and where one is
    up already). ``coordinator_address`` ('host:port'), ``num_processes``
    and ``process_id`` name the rendezvous; without them it is read from
    the environment where ``WORLD_SIZE`` or ``MASTER_ADDR`` is set, or
    ``TSSEP_MULTIHOST=1`` forces the attempt (``=0`` forces one process).
    An environment that names the processes and fails to rendezvous
    raises: N processes silently training alone would give wrong results
    with no error. ``backend`` defaults to NCCL for ``device`` 'cuda' (the
    default) and gloo for the CPU; ``timeout`` in seconds bounds every
    collective."""
    global _initialized
    if _initialized or _group_up():
        _initialized = True
        return
    kwargs = {'backend': backend or default_backend(device)}
    if timeout is not None:
        kwargs['timeout'] = datetime.timedelta(seconds=timeout)
    if num_processes is None and coordinator_address is None:
        force = os.environ.get('TSSEP_MULTIHOST')
        if force == '0':
            _initialized = True
            return
        named = any(v in os.environ for v in ('WORLD_SIZE', 'MASTER_ADDR'))
        if force == '1' or named:
            # env:// raises on a missing variable; failures raise — loud
            # by design
            _dist().init_process_group(init_method='env://', **kwargs)
            _set_device(kwargs['backend'])
    else:
        _dist().init_process_group(
            init_method=f'tcp://{coordinator_address}',
            world_size=int(num_processes), rank=int(process_id), **kwargs)
        _set_device(kwargs['backend'])
    _initialized = True


def _set_device(backend_name):
    """Under NCCL, each process takes the card of its local rank."""
    if backend_name == 'nccl' and torch.cuda.device_count() > 1:
        local = os.environ.get('LOCAL_RANK')
        torch.cuda.set_device(int(local) if local is not None
                              else process_index() % torch.cuda.device_count())


def is_initialized():
    return _initialized


def process_count():
    return _dist().get_world_size() if _group_up() else 1


def process_index():
    return _dist().get_rank() if _group_up() else 0


def backend():
    """The process group's backend ('nccl', 'gloo'); None without one."""
    return str(_dist().get_backend()) if _group_up() else None


def _collective_device():
    return torch.device('cuda') if backend() == 'nccl' else torch.device(
        'cpu')


def all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sums ``tensor`` over the group, in place; returns it. Each of
    these collectives is issued wherever a process group is up, one rank
    too, and is the identity without one."""
    if _group_up():
        _dist().all_reduce(tensor, group=group)
    return tensor


def all_gather(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``tensor`` (same shape on each), stacked by rank."""
    if not _group_up():
        return tensor[None]
    parts = [torch.empty_like(tensor)
             for _ in range(_dist().get_world_size(group))]
    _dist().all_gather(parts, tensor.contiguous(), group=group)
    return torch.stack(parts)


def all_gather_object(obj, group=None) -> list:
    """Every rank's picklable ``obj``, by rank."""
    if not _group_up():
        return [obj]
    out = [None] * _dist().get_world_size(group)
    _dist().all_gather_object(out, obj, group=group)
    return out


def broadcast(tensor: torch.Tensor, src=0, group=None) -> torch.Tensor:
    """``tensor`` of rank ``src`` on every rank, in place; returns it."""
    if _group_up():
        _dist().broadcast(tensor, src, group=group)
    return tensor


def all_reduce_host(array) -> np.ndarray:
    """A numpy array summed over the processes (on the backend's device:
    NCCL reduces on the card)."""
    array = np.asarray(array)
    if not _group_up():
        return array
    t = torch.tensor(array, device=_collective_device())
    return all_reduce(t).cpu().numpy()


def global_batch_from_local(local_batch: dict, mesh: Mesh):
    """This process's share of the global batch, as its step computes on
    it: the local rows, on the rank's device already (nothing is
    assembled: each rank is one device). Raises ``ValueError`` when the
    local batch does not divide the process's share of the data axis."""
    share = max(1, mesh.shape[DATA_AXIS] // process_count())
    for k, v in local_batch.items():
        if getattr(v, 'ndim', 0) >= 1 and v.shape[0] % share:
            raise ValueError(
                f'Batch axis of {k!r} ({v.shape[0]}) must be divisible by '
                f'the per-process share of the mesh data axis ({share}); '
                f'adjust train/validation batch size.')
    return local_batch


def host_shard_dataset(ds, n_processes=None, index=None, equalize=True):
    """Deal examples round-robin to processes (deterministic order).

    ``equalize`` truncates every process's share to ``floor(N / n)``
    examples (the ragged tail is dropped on all processes). This is
    load-bearing for finite datasets: the sharded training/validation loops
    run one collective per batch, so processes MUST see identical batch
    counts — a process with one extra example would issue a collective the
    others never join (deadlock).
    """
    if n_processes is None:
        n_processes = process_count()
    if index is None:
        index = process_index()
    if n_processes == 1:
        return ds

    from tssep_tpu_torch.data.pipeline import Dataset

    class _Sharded(Dataset):
        def __init__(self, inner):
            self.inner = inner

        def __iter__(self):
            return self.iter_from(0)

        def _limit(self):
            if equalize:
                try:
                    return len(self.inner) // n_processes
                except TypeError:
                    return None           # unsized stream: no tail to trim
            return None

        def iter_from(self, start):
            """The share from its ``start``-th example on: the inner
            dataset skips ``start`` rounds at the index level."""
            limit = self._limit()
            n_yielded = start
            for i, ex in enumerate(self.inner.iter_from(start * n_processes)):
                if i % n_processes == index:
                    if limit is not None and n_yielded >= limit:
                        break
                    n_yielded += 1
                    yield ex

        def skip_pass(self):
            self.inner.skip_pass()

        def __len__(self):
            n = len(self.inner)
            if equalize:
                return n // n_processes
            return n // n_processes + (1 if n % n_processes > index else 0)

        def __repr__(self):
            return (f'HostShardDataset({index}/{n_processes}, '
                    f'equalize={equalize})\n'
                    f'  {self.inner!r}')

    return _Sharded(ds)
