"""Training runtime: port of ``tssep_tpu/train/trainer.py``.

The padertorch ``pt.Trainer`` surface the reference configures
(``experiment.py:137-151``): clipped Adam (or SGD), gradient accumulation
(``virtual_minibatch_size``), ``summary/checkpoint/stop`` triggers counted
in iterations (optimizer steps), a registered validation hook that tracks
the best loss and may stop early, periodic checkpoints with latest/best
links and retention, snapshots, and a ``test_run`` pre-flight: two
examples through train and validate, twice, which must replicate.

``train_step`` is one micro-step of the hot path: ``Model.loss_fn`` with
``training=True``, the backward (the BLSTM layers' backward kernels among
it) and an optimizer call, which clips and updates on the last of
``virtual_minibatch_size`` micro-steps; it returns the losses as tensors
without waiting for the card, and ``iteration`` counts optimizer steps.
``train`` and ``train_steps`` are loops over it: ``train`` runs the
triggers, reading the losses back only at summary and checkpoint
boundaries.

Randomness: micro-step ``k`` draws from its own ``torch.Generator`` on the
model's device, seeded from ``(seed, iteration, k)`` as the JAX trainer
folds ``seed``, ``iteration`` and ``k`` into its key (:656-658); a
resumed run also starts its data where its predecessor stopped (skipped at
the index level, ``Dataset.iter_from``), so it draws what an uninterrupted
run draws (the JAX trainer restarts its data). The draws themselves are
torch's, not JAX's.

Data parallelism (``mesh={'data': D}``, JAX :15-30): one process a
rank, each with one device, D ranks in the process group
(``dist.multihost.initialize``; ``data=None`` takes them all). Every rank
builds the model from ``seed`` and the parameters are broadcast from rank 0
(at init and at resume); each rank's batch is its rows of the global batch
(``dist.multihost.host_shard_dataset``, or a ``DeviceSimDataset`` given
the mesh's shard), its step runs the kernels on them, and one
``all_reduce`` sums the gradients and the loss over the data group before
the clip, in every micro-step, as the JAX ``shard_map`` step ``psum``-s
them (:325-372); the losses are sums over the examples, so the sum is the
one-process gradient. The micro-step's generator draws each rank's rows
of what one process draws over the global batch
(``dist.mesh.ShardedGenerator``). Validation gathers the per-example
losses, so the best-checkpoint and early-stop decisions are the same on
every rank; rank 0 alone writes checkpoints, metrics and snapshots.
``'model' > 1`` is ROADMAP Queue 1 item 4b and raises.
"""

from __future__ import annotations

import itertools
import math
import time
from pathlib import Path

import numpy as np
import torch

from tssep_tpu_torch.config.configurable import Configurable, from_config
from tssep_tpu_torch.dist import mesh as mesh_lib
from tssep_tpu_torch.dist import multihost
from tssep_tpu_torch.train import checkpoint as ckpt_lib
from tssep_tpu_torch.train.optimizer import Adam
from tssep_tpu_torch.train.summary import ReviewSummary, SummaryWriter

__all__ = ['Trainer', 'TriggerError', 'step_generator']


class TriggerError(ValueError):
    pass


def _trigger(value):
    """Normalize ``(N, 'iteration')`` config form to int N."""
    if isinstance(value, (list, tuple)):
        n, unit = value
        if unit != 'iteration':
            raise TriggerError(f'Only iteration triggers supported: {value}')
        return int(n)
    return int(value)


def step_generator(device, *key, shard=None, examples=None
                   ) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the non-negative
    integers ``key`` (for example seed, iteration and micro-step); with a
    ``shard`` (``dist.mesh.RowShard``), a ``ShardedGenerator`` of a batch
    of ``examples`` local examples."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(
        1, np.uint64)[0]) & (2 ** 63 - 1)
    if shard is None:
        return torch.Generator(device=device).manual_seed(seed)
    return mesh_lib.ShardedGenerator(device, shard, examples).manual_seed(
        seed)


def _batch_size(batch):
    return next((v.shape[0] for v in batch.values()
                 if getattr(v, 'ndim', 0) >= 1), 1)


def _examples(per_example):
    return int(np.prod(per_example.shape)) if per_example.dim() else 1


def _datasets(ex, n, default):
    datasets = ex.get('dataset', [default] * n)
    return [datasets] * n if isinstance(datasets, str) else datasets


class Trainer(Configurable):
    """``Trainer(model, storage_dir, ...)`` with the JAX trainer's
    arguments (:174-226). ``optimizer`` is an :class:`Adam` or ``SGD``
    configuration (default: Adam, clipping 10, lr 1e-3); ``self.optimizer``
    is the update it makes over the model's parameters."""

    def __init__(self, model, storage_dir, optimizer=None, loss_weights=None,
                 summary_trigger=(1000, 'iteration'),
                 checkpoint_trigger=(1000, 'iteration'),
                 stop_trigger=(416666, 'iteration'),
                 virtual_minibatch_size=1,
                 seed=0, mesh=None, create_snapshots=True,
                 async_checkpoints=False, early_stop_patience=0):
        if isinstance(model, dict):
            model = from_config(model)
        if optimizer is None:
            optimizer = Adam()
        elif isinstance(optimizer, dict):
            optimizer = from_config(optimizer)
        self.model = model
        self.storage_dir = Path(storage_dir) if storage_dir else Path('.')
        self.loss_weights = loss_weights
        self.summary_trigger = _trigger(summary_trigger)
        self.checkpoint_trigger = _trigger(checkpoint_trigger)
        self.stop_trigger = _trigger(stop_trigger)
        self.virtual_minibatch_size = int(virtual_minibatch_size)
        self.seed = seed
        #: None (one process) or {'data': D|None, 'model': M}.
        self.mesh_config = dict(mesh) if mesh else None
        if self.mesh_config and int(self.mesh_config.get('model', 1)
                                    or 1) > 1:
            raise NotImplementedError(f'mesh={mesh!r}: {mesh_lib.ITEM_4B}')
        self.mesh = None
        #: Emit audio/spectrogram/mask-image payloads at summary and
        #: validation triggers (reference ``model.py:692-752``).
        self.create_snapshots = bool(create_snapshots)
        #: Overlap checkpoint serialization and IO with training.
        self.async_checkpoints = bool(async_checkpoints)
        #: >0: stop training after this many consecutive validations
        #: without a new best validation loss.
        self.early_stop_patience = int(early_stop_patience)
        self._validations_since_best = 0

        self.optimizer = optimizer.make(model.parameters(),
                                        self.virtual_minibatch_size)
        self.iteration = 0
        self.best_validation_loss = math.inf
        self._validation_ds = None
        self.max_checkpoints = None
        self._initialized = False
        self._writer = None

    # ------------------------------------------------------------------
    @property
    def checkpoint_dir(self):
        return self.storage_dir / 'checkpoints'

    @property
    def device(self):
        return self.model.device

    @property
    def data_parallel_size(self):
        """Batch-divisibility requirement imposed by the mesh (1 if none)."""
        if self.mesh_config is None:
            return 1
        self._ensure_mesh()
        return self.mesh.shape[mesh_lib.DATA_AXIS]

    @property
    def is_writer(self):
        """Whether this process writes checkpoints, metrics and snapshots
        (rank 0)."""
        return multihost.process_index() == 0

    def _ensure_mesh(self):
        if self.mesh_config is None or self.mesh is not None:
            return
        data_par = self.mesh_config.get('data')
        n_devices = (None if data_par in (None, -1, 'all')
                     else int(data_par))
        self.mesh = mesh_lib.make_mesh(n_devices)

    def _place_batch(self, batch):
        """This rank's batch as its step computes on it: its local rows,
        checked against its share of the data axis (the mesh spans the
        process group, a device a rank)."""
        if self.mesh is None:
            return batch
        return multihost.global_batch_from_local(batch, self.mesh)

    def _generator(self, batch, *key):
        """The generator of ``key`` for ``batch``: a rank's rows of the
        global batch's draws under a mesh."""
        if self.mesh is None:
            return step_generator(self.device, *key)
        return step_generator(self.device, *key, shard=self.mesh.shard,
                              examples=_batch_size(batch))

    def _all_reduce_grads(self, loss):
        """Sums the gradients and ``loss`` over the data group, in one
        ``all_reduce`` of a flat float32 buffer; returns the summed loss.
        The identity without a process group."""
        if self.mesh is None or multihost.backend() is None:
            return loss
        grads = [p.grad for p in self.optimizer.params if p.grad is not None]
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [loss.detach().reshape(1).float()])
        multihost.all_reduce(flat, group=self.mesh.data_group)
        with torch.no_grad():
            for g, value in zip(grads, flat.split(
                    [g.numel() for g in grads] + [1])):
                g.copy_(value.view_as(g))
        return flat[-1].to(loss.dtype)

    def ensure_init(self):
        """Applies ``loss_weights`` and initializes the parameters from
        ``seed`` (once); under a mesh, broadcasts them from rank 0."""
        self._ensure_mesh()
        if self.loss_weights:
            # padertorch ``Trainer(loss_weights=...)``: the component
            # weights onto the joint loss' weight attributes
            loss = self.model.loss
            for name, w in dict(self.loss_weights).items():
                attr = f'{name}_weight'
                if not hasattr(loss, attr):
                    raise ValueError(
                        f'loss_weights key {name!r} has no matching '
                        f'{attr!r} on {type(loss).__name__}')
                setattr(loss, attr, float(w))
            self.loss_weights = None
        if not self._initialized:
            self.model.init_params(torch.Generator().manual_seed(self.seed))
            if self.mesh is not None:
                mesh_lib.shard_params(self.model, self.mesh)
            self._initialized = True

    @property
    def writer(self):
        if self._writer is None:
            self._writer = SummaryWriter(self.storage_dir,
                                         write=self.is_writer)
        return self._writer

    # ------------------------------------------------------------------
    def train_step(self, batch: dict, k: int = 0):
        """Micro-step ``k`` of the iteration: forward, backward and an
        optimizer call (the update on the last of
        ``virtual_minibatch_size``) with the generator of (seed, iteration,
        k); counts the iteration after its last micro-step. Returns the
        loss (under a mesh, summed over the data ranks) and this rank's
        per-example losses, still on the device."""
        batch = self._place_batch(batch)
        self.optimizer.zero_grad()
        generator = self._generator(batch, self.seed, self.iteration, k)
        loss, aux = self.model.loss_fn(batch, generator, training=True)
        loss.backward()
        loss = self._all_reduce_grads(loss)
        self.optimizer.step()
        if k == self.virtual_minibatch_size - 1:
            self.iteration += 1
        return loss.detach(), aux['per_example_loss'].detach()

    def train_steps(self, dataset, num_steps: int) -> list[float]:
        """``num_steps`` iterations of ``train_step`` on batches from
        ``dataset``; returns the micro-steps' losses. No triggers,
        checkpoints or validation. Raises ``RuntimeError`` on a non-finite
        loss."""
        vmb = self.virtual_minibatch_size
        first = self.iteration
        losses = [self.train_step(batch, i % vmb)[0] for i, batch in
                  enumerate(itertools.islice(dataset, num_steps * vmb))]
        values = torch.stack(losses).tolist() if losses else []
        for i, value in enumerate(values):
            if not math.isfinite(value):
                raise RuntimeError(f'Non-finite loss {value} near iteration '
                                   f'{first + i // vmb}')
        return values

    # ------------------------------------------------------------------
    def _add_snapshots(self, batch, summary, generator, strict=False):
        """One snapshot forward (serving: masks, estimate and waveforms,
        no graph) on a batch, its audio/image payloads pushed into
        ``summary`` (reference ``model.py:692-752``). Failures are
        recorded as a scalar in the training loop; ``strict=True`` (the
        test_run pre-flight) re-raises."""
        if not self.create_snapshots or not hasattr(
                self.model, 'add_snapshots') or not (strict
                                                     or self.is_writer):
            return
        try:
            out = self.model(batch, generator, training=False)
            self.model.add_snapshots(batch, out, summary)
        except Exception as e:  # noqa: BLE001 - must not stop training
            if strict:
                raise
            summary.add_scalar('snapshot_errors', 1.0)
            print(f'snapshot failed: {e!r}')

    # ------------------------------------------------------------------
    def register_validation_hook(self, validation_ds, max_checkpoints=None):
        self._validation_ds = validation_ds
        #: Retention: keep at most this many ``ckpt_<it>.npz`` files (the
        #: best/latest symlink targets are always kept; ``None`` keeps all).
        self.max_checkpoints = max_checkpoints

    def _prune_checkpoints(self):
        limit = self.max_checkpoints
        if not limit:
            return
        keep = set()
        for link in ('ckpt_latest.npz', 'ckpt_best_loss.npz'):
            p = self.checkpoint_dir / link
            if p.is_symlink() or p.exists():
                keep.add(p.resolve().name)
        numbered = sorted(
            (p for p in self.checkpoint_dir.glob('ckpt_*.npz')
             if p.stem.split('_')[-1].isdigit()),
            key=lambda p: int(p.stem.split('_')[-1]))
        for p in numbered[:-limit]:
            if p.name not in keep:
                p.unlink()

    def validate(self, generator_seed=None):
        """A full pass over the validation set; returns (mean loss over
        the examples, summary). Batch i draws from the generator of
        (``seed`` + 1, i)."""
        assert self._validation_ds is not None
        self.ensure_init()
        seed = self.seed + 1 if generator_seed is None else generator_seed
        summary = ReviewSummary()
        name = self.model.loss.name
        pers, sums, labels = [], [], []
        for i, ex in enumerate(self._validation_ds):
            ex = self._place_batch(ex)
            gen = self._generator(ex, seed, i)
            if i == 0:
                # rich snapshots for the first validation batch
                self._add_snapshots(ex, summary,
                                    self._generator(ex, seed, i))
            with torch.no_grad():
                loss_sum, aux = self.model.loss_fn(ex, gen, training=False)
            pers.append(torch.atleast_1d(aux['per_example_loss']).float())
            sums.append(loss_sum.detach().float().reshape(1))
            labels.append(_datasets(ex, len(pers[-1]), 'validate'))
        if not pers:
            raise RuntimeError(
                'Validation dataset yielded no batches: under a mesh, with '
                'drop_last, the validation set is smaller than the '
                '(per-process) validation batch size')
        pers, labels, sums = self._gather_batches(pers, labels, sums)
        for per_example, names, loss_sum in zip(pers, labels, sums):
            for ds_name, lv in zip(names, per_example):
                summary.add_scalar(f'{ds_name}_{name}', lv)
                summary.add_histogram(f'hist_{ds_name}_{name}', lv)
            summary.add_to_loss(float(loss_sum))
        return float(np.mean(np.concatenate(pers).astype(np.float64))), \
            summary

    def _gather_batches(self, pers, labels, sums=None):
        """Per batch: the per-example values (numpy), their dataset names
        and, given ``sums``, the loss sums of the global batch, in its row
        order; under a mesh, one ``all_gather`` of the values and one of
        the names for all the batches (every rank holds as many batches of
        as many rows)."""
        sums = [] if sums is None else sums
        flat = torch.cat([*pers, *sums])
        if self.mesh is None:
            stacked, names = flat[None].cpu().numpy(), [labels]
        else:
            stacked = multihost.all_gather(
                flat, group=self.mesh.data_group).cpu().numpy()
            names = multihost.all_gather_object(labels)
        ranks = range(stacked.shape[0])
        values, out_labels, start = [], [], 0
        for i, per in enumerate(pers):
            n = len(per)
            values.append(stacked[:, start:start + n].T.reshape(-1))
            out_labels.append([names[r][i][j] for j in range(n)
                               for r in ranks])
            start += n
        summed = list(stacked[:, start:].sum(axis=0)) if sums else None
        return values, out_labels, summed

    # ------------------------------------------------------------------
    def test_run(self, train_ds, validation_ds, deterministic_atol=1e-5,
                 deterministic_rtol=1e-5, loss_atol=1e-5, loss_rtol=1e-5,
                 virtual_minibatch_size=1):
        """Pre-flight: 2 examples through train (forward and backward, no
        update) and 2 through validate, twice, with the same generators:
        the losses and the gradient norms must replicate to the given
        tolerances (``tssep_tpu/train/trainer.py:507-566``)."""
        self.ensure_init()
        model = self.model
        params = [p for p in model.parameters() if p.requires_grad]

        def grad_norm(batch, gen):
            loss, _ = model.loss_fn(batch, gen, training=True)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            gn = sum(g.float().square().sum() for g in grads if g is not None)
            return float(loss.detach()), float(torch.sqrt(gn))

        results = []
        for repetition in range(2):
            rep = []
            j = 0
            for ds, training in ((train_ds, True), (validation_ds, False)):
                for ex in itertools.islice(iter(ds), 2):
                    gen = step_generator(self.device, self.seed + 123, j)
                    j += 1
                    if training:
                        loss, gn = grad_norm(ex, gen)
                        assert np.isfinite(loss), loss
                        assert np.isfinite(gn) and gn > 0, gn
                        rep.append((loss, gn))
                    else:
                        if repetition == 0 and len(rep) == 2 \
                                and self.create_snapshots:
                            # the snapshot path strictly, on the first
                            # validation batch
                            self._add_snapshots(
                                ex, ReviewSummary(),
                                step_generator(self.device, self.seed + 123,
                                               j - 1), strict=True)
                        with torch.no_grad():
                            loss_sum, _ = model.loss_fn(ex, gen,
                                                        training=False)
                        loss = float(loss_sum)
                        assert np.isfinite(loss), loss
                        rep.append((loss,))
            results.append(rep)
        for a, b in zip(*results):
            np.testing.assert_allclose(
                a[0], b[0], atol=loss_atol, rtol=loss_rtol,
                err_msg='test_run: non-replicating loss')
            if len(a) > 1:
                np.testing.assert_allclose(
                    a[1], b[1], atol=deterministic_atol,
                    rtol=deterministic_rtol,
                    err_msg='test_run: non-deterministic gradient')
        return results[0]

    # ------------------------------------------------------------------
    def save(self, best=False):
        """Writes a checkpoint from rank 0 (the data ranks hold the same
        parameters and optimizer state, so nothing is gathered; the other
        ranks return None)."""
        path = ckpt_lib.save_checkpoint(
            self.checkpoint_dir, self.iteration, self.model,
            optimizer=self.optimizer,
            meta={'best_validation_loss': self.best_validation_loss,
                  'validations_since_best': self._validations_since_best},
            best=best, async_write=self.async_checkpoints,
            write=self.is_writer, after_write=self._prune_checkpoints)
        if not self.async_checkpoints and self.is_writer:
            self._prune_checkpoints()
        return path

    def load(self, path):
        """The parameters, the optimizer state (where the file holds the
        port's), the iteration, the best validation loss and the patience
        counter of a checkpoint."""
        ckpt_lib.wait_for_pending()
        self.ensure_init()
        _, _, meta = ckpt_lib.load_checkpoint(path, self.model,
                                              self.optimizer)
        if self.mesh is not None:
            mesh_lib.shard_params(self.model, self.mesh)
        self.iteration = int(meta.get('iteration', 0))
        self.best_validation_loss = float(
            meta.get('best_validation_loss', math.inf))
        self._validations_since_best = int(
            meta.get('validations_since_best', 0))

    # ------------------------------------------------------------------
    def train(self, train_ds, resume=False):
        """Trains until ``stop_trigger`` (or an early stop); returns the
        iteration reached. With ``resume``, starts from
        ``ckpt_latest.npz`` where there is one."""
        self.ensure_init()
        if resume:
            latest = ckpt_lib.latest_checkpoint(self.checkpoint_dir)
            if latest is not None:
                self.load(latest)

        vmb = self.virtual_minibatch_size
        done = self.iteration * vmb         # the batches a resumed run skips
        data = train_ds.tile(None).iter_from(done) \
            if hasattr(train_ds, 'tile') \
            else itertools.islice(itertools.cycle(train_ds), done, None)
        summary = ReviewSummary()
        t_start = time.time()
        examples_seen = 0
        name = self.model.loss.name
        # losses stay on the device until a summary or checkpoint boundary
        pending = []

        def drain_pending():
            nonlocal pending
            if not pending:
                return
            losses = torch.stack([p[0] for p in pending]).float().tolist()
            pers, labels, _ = self._gather_batches(
                [torch.atleast_1d(p[1]).float() for p in pending],
                [p[2] for p in pending])
            for step_loss, per, datasets in zip(losses, pers, labels):
                if not math.isfinite(step_loss):
                    raise RuntimeError(
                        f'Non-finite loss {step_loss} near iteration '
                        f'{self.iteration}')
                summary.add_to_loss(step_loss)
                for ds_name, lv in zip(datasets, per):
                    summary.add_scalar(f'{ds_name}_{name}', lv)
            pending = []

        last_saved = self.iteration if self.iteration else -1
        while self.iteration < self.stop_trigger:
            for k in range(vmb):
                ex = next(data)
                loss, per = self.train_step(ex, k)
                n = _examples(per)
                examples_seen += max(n, 1) * self.data_parallel_size
                pending.append((loss, per, _datasets(ex, max(n, 1),
                                                     'train')))

            if self.iteration % self.summary_trigger == 0:
                drain_pending()
                elapsed = time.time() - t_start
                summary.add_scalar('examples_per_second',
                                   examples_seen / max(elapsed, 1e-9))
                self._add_snapshots(ex, summary, step_generator(
                    self.device, self.seed, self.iteration - 1, vmb - 1))
                self.writer.flush(summary, self.iteration, prefix='train/')
                summary = ReviewSummary()

            if (self.iteration % self.checkpoint_trigger == 0
                    or self.iteration >= self.stop_trigger):
                drain_pending()
                best = False
                if self._validation_ds is not None:
                    val_loss, val_summary = self.validate()
                    self.writer.flush(val_summary, self.iteration,
                                      prefix='validation/')
                    self.writer.scalar('validation/mean_loss', val_loss,
                                       self.iteration)
                    if val_loss < self.best_validation_loss:
                        self.best_validation_loss = val_loss
                        best = True
                        self._validations_since_best = 0
                    else:
                        self._validations_since_best += 1
                self.save(best=best)
                last_saved = self.iteration
                if (self.early_stop_patience
                        and self._validations_since_best
                        >= self.early_stop_patience):
                    print(f'Early stop at iteration {self.iteration}: no '
                          f'validation improvement for '
                          f'{self._validations_since_best} validations '
                          f'(best {self.best_validation_loss:.6g})')
                    break

        drain_pending()
        ckpt_lib.wait_for_pending()
        if last_saved != self.iteration:    # the loop ended off-trigger
            self.save()
            ckpt_lib.wait_for_pending()
        self.close()
        return self.iteration

    def close(self):
        """Closes the summary writer (it reopens, appending, if training
        resumes on the same Trainer)."""
        if self._writer is not None:
            try:
                self._writer.close()
            finally:
                self._writer = None
