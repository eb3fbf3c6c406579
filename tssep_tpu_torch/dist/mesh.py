"""Rank mesh and sharding rules: port of ``tssep_tpu/dist/mesh.py`` on
``torch.distributed``.

One JAX device is one torch rank here, and each rank has one device: the
card (NCCL) or the CPU (gloo). A mesh of D x M devices is a process group of
D x M ranks, laid out as JAX's ``make_mesh`` lays out its devices: rank r
sits at (r // M, r % M), and the data axis spans the ranks whose model
index is the same.

- parameters: every rank builds the model from the same seed, and
  ``shard_params`` broadcasts them from rank 0 all the same (replicated:
  the data axis);
- batches: each rank holds its rows of the global batch. Row j of rank r's
  local batch is row ``j * D + r`` of the global batch, the rows that
  ``multihost.host_shard_dataset`` deals it (examples round-robin, then
  batched), so ``shard_batch`` and every per-example draw use the same
  rows (``batch_rand``);
- gradients: summed over the data group by one ``all_reduce`` that the
  trainer issues itself (``train/trainer.py``), where the JAX package's
  ``shard_map`` step ``psum``-s them.

Tensor parallelism (``'model' > 1``, the gate matrices sharded over the
model ranks) is ROADMAP Queue 1 item 4b: the grid and ``_param_spec`` are
here, ``shard_params`` and the trainer raise for it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ['make_mesh', 'param_shardings', 'batch_shardings', 'shard_params',
           'shard_batch', 'DATA_AXIS', 'MODEL_AXIS', 'Mesh', 'RowShard',
           'ShardedGenerator', 'batch_rand', 'gather_rows', 'ITEM_4B']

DATA_AXIS = 'data'
MODEL_AXIS = 'model'

#: Where tensor parallelism stands.
ITEM_4B = ('tensor parallelism (mesh model > 1) is ROADMAP Queue 1 '
           'item 4b')


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A data rank's rows of a global batch: row j of the local batch is
    row ``j * size + index`` of the global one."""
    index: int
    size: int

    def local(self, n_global: int) -> int:
        """The local batch size; raises ``ValueError`` unless the global
        batch divides the data axis."""
        if n_global % self.size:
            raise ValueError(f'Batch axis ({n_global}) must be divisible by '
                             f'the mesh data axis ({self.size}); adjust '
                             f'train/validation batch size.')
        return n_global // self.size

    def rows(self, n_global: int) -> slice:
        self.local(n_global)
        return slice(self.index, None, self.size)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ('data', 'model') grid of ranks seen from ``rank``.

    ``data_group`` is the process group of ``rank``'s data axis (None: the
    default group, which it is when the model axis is 1). A mesh made for a
    given ``rank`` without a process group (``make_mesh(rank=...)``) plans
    shardings; it issues no collective."""
    grid: np.ndarray
    rank: int
    data_group: object = None
    logical: bool = False

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: int(self.grid.shape[0]),
                MODEL_AXIS: int(self.grid.shape[1])}

    @property
    def coords(self) -> tuple:
        """``rank``'s (data index, model index)."""
        d, m = np.argwhere(self.grid == self.rank)[0]
        return int(d), int(m)

    @property
    def shard(self) -> RowShard:
        """``rank``'s rows of a batch sharded over 'data'."""
        return RowShard(self.coords[0], self.shape[DATA_AXIS])

    def __repr__(self):
        return f'Mesh({self.shape}, rank={self.rank})'


def _world():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_devices=None, model_parallel=1, rank=None) -> Mesh:
    """A ('data', 'model') mesh over the ranks of the initialized process
    group (one process and rank 0 where none is), ``n_devices`` of them
    (default: all); raises if ``n_devices`` is not the world size. With
    ``rank``, a mesh of ``n_devices`` ranks seen from ``rank`` without a
    process group, for planning and tests."""
    world, own = _world()
    if rank is None and n_devices is not None and n_devices != world:
        raise ValueError(
            f'make_mesh(n_devices={n_devices}): the process group has '
            f'{world} rank(s), one device each; start {n_devices} processes '
            f'(python -m torch.distributed.run --nproc_per_node=...)')
    n = world if n_devices is None else int(n_devices)
    if n % model_parallel:
        raise ValueError(f'{n} ranks do not divide into model_parallel='
                         f'{model_parallel}')
    grid = np.arange(n).reshape(n // model_parallel, model_parallel)
    if rank is not None:
        return Mesh(grid, int(rank), None, True)
    group = None
    if model_parallel > 1 and world > 1:
        # every rank creates every group, in the same order
        for m in range(model_parallel):
            g = torch.distributed.new_group([int(r) for r in grid[:, m]])
            if own in grid[:, m]:
                group = g
    return Mesh(grid, own, group)


def _param_spec(name: str, shape, model_size: int) -> tuple:
    """Sharding rule for one parameter, keyed on its dotted name: the mesh
    axis of each dimension (JAX's ``PartitionSpec`` as a tuple)."""
    if len(shape) == 0:
        return ()
    # LSTM gate matrices / biases: first dim is 4H -> shard over 'model'
    if 'weight_ih' in name or 'weight_hh' in name:
        if shape[0] % model_size == 0:
            return (MODEL_AXIS, None)
        return ()
    if 'bias_ih' in name or 'bias_hh' in name:
        if shape[0] % model_size == 0:
            return (MODEL_AXIS,)
        return ()
    # Projection / head linears: shard the output dim when large & divisible
    if name.endswith('.weight') and len(shape) == 2:
        if shape[0] >= 2 * model_size and shape[0] % model_size == 0:
            return (MODEL_AXIS, None)
        return ()
    return ()


def _named_tensors(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return params.state_dict()
    return dict(params)


def param_shardings(params, mesh: Mesh) -> dict:
    """``{dotted name: spec}`` of a module's state (or a ``{name:
    tensor}`` dict); every spec is ``()`` (replicated) when the model axis
    is 1."""
    model_size = mesh.shape[MODEL_AXIS]
    return {name: (_param_spec(name, tuple(t.shape), model_size)
                   if model_size > 1 else ())
            for name, t in _named_tensors(params).items()}


def shard_params(params, mesh: Mesh):
    """Broadcasts a module's state (or a ``{name: tensor}`` dict) from
    rank 0 over the process group, in place, one broadcast per dtype;
    returns ``params``."""
    if mesh.shape[MODEL_AXIS] > 1:
        raise NotImplementedError(ITEM_4B)
    if mesh.logical:
        return params
    from tssep_tpu_torch.dist import multihost
    tensors = list(_named_tensors(params).values())
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        multihost.broadcast(flat)
        with torch.no_grad():
            for t, value in zip(group, flat.split([t.numel()
                                                   for t in group])):
                t.copy_(value.view_as(t))
    return params


def _batch_size(batch: dict):
    return next((v.shape[0] for v in batch.values()
                 if getattr(v, 'ndim', 0) >= 1), None)


def batch_shardings(batch: dict, mesh: Mesh) -> dict:
    """``{key: rows}``: the rows of ``mesh.rank`` of every leaf with a
    batch axis (tensors and arrays of rank >= 1, lists as long as the
    batch), None for the replicated rest. Raises ``ValueError`` when the
    batch does not divide the data axis."""
    n = _batch_size(batch)
    rows = mesh.shard.rows(n) if n is not None else None

    def spec(value):
        if getattr(value, 'ndim', 0) >= 1 or (
                isinstance(value, (list, tuple)) and len(value) == n):
            return rows
        return None
    return {k: spec(v) for k, v in batch.items()}


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """``mesh.rank``'s rows of a global batch."""
    return {k: (v if rows is None else v[rows])
            for (k, v), rows in zip(batch.items(),
                                    batch_shardings(batch, mesh).values())}


def gather_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch from every data rank's rows (``all_gather``, then
    rows interleaved back into the global order)."""
    if mesh.logical:
        raise ValueError(f'{mesh!r} has no process group to gather over')
    from tssep_tpu_torch.dist import multihost
    stacked = multihost.all_gather(local, group=mesh.data_group)
    return stacked.transpose(0, 1).reshape(-1, *local.shape[1:])


class ShardedGenerator(torch.Generator):
    """A ``torch.Generator`` whose draws over a batch axis
    (``batch_rand``) are a data rank's rows of the draws one process makes
    over the global batch: every rank draws the global tensor and keeps
    its rows, so the per-example randomness does not depend on the
    sharding. ``examples`` is the local batch size."""

    def __new__(cls, device, shard: RowShard, examples: int):
        return super().__new__(cls, device=device)

    def __init__(self, device, shard: RowShard, examples: int):
        super().__init__()
        self.shard = shard
        self.examples = int(examples)


def batch_rand(generator: torch.Generator, shape, draw=torch.rand):
    """``draw(shape)`` from ``generator`` on its device, ``shape[0]`` a
    batch axis of the local examples, each ``k`` rows, the examples
    outermost. From a ``ShardedGenerator``: the rank's examples' rows of
    the draw over the global batch."""
    shard = getattr(generator, 'shard', None)
    if shard is None or shard.size == 1:
        return draw(tuple(shape), generator=generator,
                    device=generator.device)
    b, rest = generator.examples, tuple(shape[1:])
    k, ragged = divmod(shape[0], b)
    if ragged:
        raise ValueError(f'A draw of {shape[0]} rows over a batch of {b} '
                         f'examples')
    full = draw((b * shard.size * k, *rest), generator=generator,
                device=generator.device)
    return full.reshape(b, shard.size, k, *rest)[:, shard.index].reshape(
        b * k, *rest)
