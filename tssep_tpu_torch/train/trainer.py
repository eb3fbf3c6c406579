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

``mesh`` (data and model parallelism) is ROADMAP Queue 1 item 4 and raises.
"""

from __future__ import annotations

import itertools
import math
import time
from pathlib import Path

import numpy as np
import torch

from tssep_tpu_torch.config.configurable import Configurable, from_config
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


def step_generator(device, *key) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the non-negative
    integers ``key`` (for example seed, iteration and micro-step)."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(
        1, np.uint64)[0]) & (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(seed)


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
        if mesh:
            raise NotImplementedError(
                f'mesh={mesh!r}: data and model parallelism on '
                f'torch.distributed is ROADMAP Queue 1 item 4')
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

    def ensure_init(self):
        """Applies ``loss_weights`` and initializes the parameters from
        ``seed`` (once)."""
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
            self._initialized = True

    @property
    def writer(self):
        if self._writer is None:
            self._writer = SummaryWriter(self.storage_dir)
        return self._writer

    # ------------------------------------------------------------------
    def train_step(self, batch: dict, k: int = 0):
        """Micro-step ``k`` of the iteration: forward, backward and an
        optimizer call (the update on the last of
        ``virtual_minibatch_size``) with the generator of (seed, iteration,
        k); counts the iteration after its last micro-step. Returns the
        loss and the per-example losses, still on the device."""
        self.optimizer.zero_grad()
        generator = step_generator(self.device, self.seed, self.iteration, k)
        loss, aux = self.model.loss_fn(batch, generator, training=True)
        loss.backward()
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
        if not self.create_snapshots or not hasattr(self.model,
                                                    'add_snapshots'):
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
        losses = []
        name = self.model.loss.name
        for i, ex in enumerate(self._validation_ds):
            gen = step_generator(self.device, seed, i)
            if i == 0:
                # rich snapshots for the first validation batch
                self._add_snapshots(ex, summary,
                                    step_generator(self.device, seed, i))
            with torch.no_grad():
                loss_sum, aux = self.model.loss_fn(ex, gen, training=False)
            per_example = np.atleast_1d(
                aux['per_example_loss'].float().cpu().numpy())
            losses.extend(per_example.tolist())
            for ds_name, lv in zip(_datasets(ex, len(per_example),
                                             'validate'), per_example):
                summary.add_scalar(f'{ds_name}_{name}', lv)
                summary.add_histogram(f'hist_{ds_name}_{name}', lv)
            summary.add_to_loss(float(loss_sum))
        if not losses:
            raise RuntimeError('Validation dataset yielded no batches')
        return float(np.mean(losses)), summary

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
        path = ckpt_lib.save_checkpoint(
            self.checkpoint_dir, self.iteration, self.model,
            optimizer=self.optimizer,
            meta={'best_validation_loss': self.best_validation_loss,
                  'validations_since_best': self._validations_since_best},
            best=best, async_write=self.async_checkpoints,
            after_write=self._prune_checkpoints)
        if not self.async_checkpoints:
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
            for step_loss, (_, per, datasets) in zip(losses, pending):
                if not math.isfinite(step_loss):
                    raise RuntimeError(
                        f'Non-finite loss {step_loss} near iteration '
                        f'{self.iteration}')
                summary.add_to_loss(step_loss)
                per = np.atleast_1d(per.float().cpu().numpy())
                for ds_name, lv in zip(datasets, per):
                    summary.add_scalar(f'{ds_name}_{name}', lv)
            pending = []

        last_saved = self.iteration if self.iteration else -1
        while self.iteration < self.stop_trigger:
            for k in range(vmb):
                ex = next(data)
                loss, per = self.train_step(ex, k)
                n = _examples(per)
                examples_seen += max(n, 1)
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
