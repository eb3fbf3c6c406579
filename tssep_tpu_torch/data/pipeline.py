"""Lazy dataset pipeline (host side): a copy of ``tssep_tpu/data/pipeline.py``
with the same semantics (the port imports nothing of the JAX package).

The capabilities the reference model uses to own its data pipeline
(``tssep/train/model.py:182-337``): lazy map/sort/shuffle(reshuffle)/batch,
threaded prefetch with exception-filtering (a failing example is dropped,
training continues), and ``catch()``.

Deterministic: shuffling is seedable (``np.random.RandomState(seed)``, as
the JAX package) and reshuffles per epoch; iteration order is reproducible
given the seed.

Beyond the copy, ``iter_from(start)`` resumes a pass at its ``start``-th
example without running the map functions on the skipped ones, and
``skip_pass`` advances a whole pass (a reshuffle's random state) without
producing an example; a resumed training run uses them to reach the
position of an uninterrupted one.
"""

from __future__ import annotations

import collections
import concurrent.futures
import itertools
import logging

import numpy as np

__all__ = ['Dataset', 'ListDataset', 'new', 'FilterException']

logger = logging.getLogger(__name__)


class FilterException(Exception):
    """Raise inside a map function to silently drop the example."""


class Dataset:
    """Base class: iterable (possibly infinite) of examples."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise TypeError(f'{type(self).__name__} has no length')

    # -- transforms --------------------------------------------------------
    def map(self, fn):
        return MapDataset(self, fn)

    def batch(self, batch_size, drop_last=False):
        return BatchDataset(self, batch_size, drop_last)

    def shuffle(self, reshuffle=False, rng=None, seed=0):
        return ShuffleDataset(self, reshuffle=reshuffle, rng=rng, seed=seed)

    def sort(self, key_fn, reverse=False):
        items = sorted(self, key=key_fn, reverse=reverse)
        return ListDataset(items)

    def copy(self, freeze=False):
        if freeze:
            return ListDataset(list(self))
        return self

    def catch(self, exceptions=(Exception,)):
        return CatchDataset(self, exceptions)

    def prefetch(self, num_workers, buffer_size, catch_filter_exception=False,
                 backend='t'):
        return PrefetchDataset(self, num_workers, buffer_size,
                               catch_filter_exception)

    def tile(self, reps=None):
        """Repeat the dataset ``reps`` times (None: endless)."""
        return TileDataset(self, reps)

    # -- resuming ------------------------------------------------------------
    def iter_from(self, start):
        """One pass from its ``start``-th example on, as
        ``islice(iter(self), start, None)``. The subclasses skip at the
        index level, so the map functions do not run on the skipped
        examples; where a catch drops an example, the count is of the
        examples before the drop."""
        return itertools.islice(iter(self), start, None)

    def skip_pass(self):
        """Advances what a whole pass advances, without producing an
        example."""
        for _ in self:
            pass

    def __repr__(self):
        return f'{type(self).__name__}()'


class ListDataset(Dataset):
    def __init__(self, examples):
        self.examples = list(examples)

    def __iter__(self):
        return iter(self.examples)

    def iter_from(self, start):
        return iter(self.examples[start:])

    def skip_pass(self):
        pass

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, i):
        return self.examples[i]

    def __repr__(self):
        return f'ListDataset(len={len(self.examples)})'


def new(examples):
    return ListDataset(examples)


class MapDataset(Dataset):
    def __init__(self, ds, fn):
        self.ds = ds
        self.fn = fn

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start):
        for ex in self.ds.iter_from(start):
            yield self.fn(ex)

    def skip_pass(self):
        self.ds.skip_pass()

    def __len__(self):
        return len(self.ds)

    def __repr__(self):
        return f'MapDataset({getattr(self.fn, "__name__", self.fn)!r})\n  {self.ds!r}'


class BatchDataset(Dataset):
    def __init__(self, ds, batch_size, drop_last=False):
        self.ds = ds
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        return self.iter_from(0)

    def skip_pass(self):
        self.ds.skip_pass()

    def iter_from(self, start):
        batch = []
        for ex in self.ds.iter_from(start * self.batch_size):
            batch.append(ex)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __repr__(self):
        return f'BatchDataset({self.batch_size})\n  {self.ds!r}'


class ShuffleDataset(Dataset):
    def __init__(self, ds, reshuffle=False, rng=None, seed=0):
        self.ds = ds
        self.reshuffle = reshuffle
        self.rng = rng if rng is not None else np.random.RandomState(seed)
        self._epoch_order = None

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start):
        # the pass's examples are all made, as in a pass from its start
        items = list(self.ds)
        if self.reshuffle or self._epoch_order is None:
            self._epoch_order = self.rng.permutation(len(items))
        for i in self._epoch_order[start:]:
            yield items[i]

    def skip_pass(self):
        self.ds.skip_pass()
        if self.reshuffle or self._epoch_order is None:
            self._epoch_order = self.rng.permutation(len(self.ds))

    def __len__(self):
        return len(self.ds)

    def __repr__(self):
        return f'ShuffleDataset(reshuffle={self.reshuffle})\n  {self.ds!r}'


class CatchDataset(Dataset):
    """Drops examples whose map chain raises (a raising generator would be
    closed, so the map-fn chain is applied item-wise here)."""

    def __init__(self, ds, exceptions=(Exception,)):
        self.ds = ds
        self.exceptions = tuple(exceptions)

    def __iter__(self):
        return self.iter_from(0)

    def skip_pass(self):
        self.ds.skip_pass()

    def iter_from(self, start):
        base, fns = PrefetchDataset._decompose(self.ds)
        for item in base.iter_from(start):
            try:
                for fn in fns:
                    item = fn(item)
            except self.exceptions as e:
                logger.warning('Dropped example after %s: %s',
                               type(e).__name__, e)
                continue
            yield item

    def __len__(self):
        return len(self.ds)

    def __repr__(self):
        return f'CatchDataset()\n  {self.ds!r}'


class TileDataset(Dataset):
    def __init__(self, ds, reps=None):
        self.ds = ds
        self.reps = reps

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start):
        """Whole passes before ``start`` are skipped by ``skip_pass``."""
        i = 0
        if start:
            i, start = divmod(start, len(self.ds))
            if self.reps is not None:
                i = min(i, self.reps)
            for _ in range(i):
                self.ds.skip_pass()
        while self.reps is None or i < self.reps:
            yield from self.ds.iter_from(start)
            start = 0
            i += 1

    def skip_pass(self):
        if self.reps is None:
            raise TypeError('an endless dataset has no end to skip to')
        for _ in range(self.reps):
            self.ds.skip_pass()

    def __len__(self):
        if self.reps is None:
            raise TypeError('endless dataset has no length')
        return self.reps * len(self.ds)

    def __repr__(self):
        return f'TileDataset(reps={self.reps})\n  {self.ds!r}'


class PrefetchDataset(Dataset):
    """Threaded prefetch preserving order; failing examples are dropped when
    ``catch_filter_exception`` is set (reference semantics,
    ``model.py:313-317``)."""

    def __init__(self, ds, num_workers, buffer_size, catch_filter_exception=False):
        self.ds = ds
        self.num_workers = max(1, int(num_workers))
        self.buffer_size = max(1, int(buffer_size))
        self.catch_filter_exception = catch_filter_exception

    def __iter__(self):
        return self.iter_from(0)

    def skip_pass(self):
        self.ds.skip_pass()

    def iter_from(self, start):
        # Decompose the (typically Map(Map(...Base))) chain: iterate the
        # cheap base on this thread, run the map-fn composition in the pool.
        # (Generators are not thread-safe, so the base is never shared.)
        base, fns = self._decompose(self.ds)

        def work(item):
            for fn in fns:
                item = fn(item)
            return item

        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            src = base.iter_from(start)
            window = collections.deque()
            exhausted = False

            def refill():
                nonlocal exhausted
                while not exhausted and len(window) < self.buffer_size:
                    try:
                        item = next(src)
                    except StopIteration:
                        exhausted = True
                        return
                    window.append(pool.submit(work, item))

            refill()
            while window:
                fut = window.popleft()
                refill()
                try:
                    value = fut.result()
                except Exception as e:  # noqa: BLE001
                    if self.catch_filter_exception:
                        logger.warning('Dropped example: %r', e)
                        continue
                    raise
                yield value

    @staticmethod
    def _decompose(ds):
        fns = []
        while isinstance(ds, MapDataset):
            fns.append(ds.fn)
            ds = ds.ds
        fns.reverse()
        return ds, fns

    def __len__(self):
        return len(self.ds)

    def __repr__(self):
        return (f'PrefetchDataset({self.num_workers}, {self.buffer_size})\n'
                f'  {self.ds!r}')
