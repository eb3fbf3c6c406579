"""Experiment orchestration: port of ``tssep_tpu/train/experiment.py``
(reference ``tssep/train/experiment.py``). Resume detection, the warm start,
the sorted pre-flight ``test_run``, the validation hook, the log files and
the reports, then the trainer loop. Under a mesh (JAX :77-140) the
process group is joined first (``dist.multihost.initialize``), both batch
sizes must divide the data axis, and each process pipelines its
round-robin share of the examples (``host_shard``) in batches of its share
of the global batch size, dropping a ragged last batch."""

from __future__ import annotations

from tssep_tpu_torch.config.configurable import Configurable, from_config
from tssep_tpu_torch.dist import mesh as mesh_lib
from tssep_tpu_torch.dist import multihost
from tssep_tpu_torch.tasks.model import Model
from tssep_tpu_torch.train import track
from tssep_tpu_torch.train.init_ckpt import InitCheckPoint
from tssep_tpu_torch.train.optimizer import Adam
from tssep_tpu_torch.train.trainer import Trainer

__all__ = ['Experiment']


class Experiment(Configurable):
    @classmethod
    def finalize_dogmatic_config(cls, config):
        virtual_minibatch_size = 12
        config['trainer'] = {
            'factory': Trainer,
            'model': {'factory': Model},
            'summary_trigger': [1000 // virtual_minibatch_size, 'iteration'],
            'checkpoint_trigger': [12000 // virtual_minibatch_size,
                                   'iteration'],
            'stop_trigger': [5_000_000 // virtual_minibatch_size,
                             'iteration'],
            'virtual_minibatch_size': virtual_minibatch_size,
            'optimizer': {'factory': Adam, 'gradient_clipping': 10},
            'mesh': None,
        }
        config['init_ckpt'] = {'factory': InitCheckPoint}

    def __init__(self, trainer, train_batchsize=None,
                 validation_batchsize=None, init_ckpt=None,
                 init_ckpt_strict=True, cache_datasets_on_device=False,
                 max_checkpoints=None):
        #: Materialize the train/validation batches on the device once and
        #: cycle them (only the batch order reshuffles).
        self.cache_datasets_on_device = cache_datasets_on_device
        if isinstance(trainer, dict):
            trainer = from_config(trainer)
        if isinstance(init_ckpt, dict):
            init_ckpt = from_config(init_ckpt)
        self.trainer: Trainer = trainer
        self.train_batchsize = train_batchsize
        self.validation_batchsize = validation_batchsize
        self.init_ckpt = init_ckpt if init_ckpt is not None else InitCheckPoint()
        self.init_ckpt_strict = init_ckpt_strict
        #: Checkpoint retention: keep at most this many numbered
        #: ``ckpt_<it>.npz`` (best/latest always kept); None keeps all.
        self.max_checkpoints = max_checkpoints

    def load_model_state_dict(self, ckpt, strict=True):
        return InitCheckPoint(init_ckpt=str(ckpt),
                              strict=strict).load_model_state_dict(self, ckpt)

    def add_log_files(self, **kwargs):
        if multihost.process_index() != 0:
            return
        log_dir = self.trainer.storage_dir / 'log'
        log_dir.mkdir(exist_ok=True, parents=True)
        (log_dir / 'experiment.txt').write_text(repr(self))
        model = self.trainer.model
        (log_dir / 'model.txt').write_text(
            f'{type(model).__name__}\n'
            f'  fe: {type(model.fe).__name__}\n'
            f'  mask_estimator params: {model.num_params():_}\n'
            f'  enhancer: {model.enhancer.name}\n'
            f'  loss: {model.loss.name}(target={model.loss.target!r})\n'
            f'  storage: {model.mask_estimator.storage_dtype}, device: '
            f'{model.device}\n')
        for k, v in kwargs.items():
            (log_dir / f'{k}.txt').write_text(str(v))

    def train(self):
        trainer = self.trainer
        model = trainer.model
        if trainer.mesh_config is not None:
            # the rendezvous precedes any other use of the process group
            multihost.initialize(device=model.device)
        resume = (trainer.checkpoint_dir / 'ckpt_latest.npz').is_file()

        trainer.ensure_init()
        if not resume:
            self.init_ckpt(self)
            if trainer.mesh is not None:
                # every rank read the warm start; all keep rank 0's
                mesh_lib.shard_params(model, trainer.mesh)

        dp = trainer.data_parallel_size
        if dp > 1:
            for name, bs in (('train_batchsize', self.train_batchsize),
                             ('validation_batchsize',
                              self.validation_batchsize)):
                if bs is None or bs % dp != 0:
                    raise ValueError(
                        f'{name}={bs} must be set and divisible by the mesh '
                        f'data axis ({dp})')

        # Pre-flight: sorted (longest-first) datasets so that running out
        # of memory happens now, not at hour 30 (reference
        # model.py:199-219); on each rank alone, no collective.
        test_run_train_ds = model.prepare_train_dataset(
            prefetch=False, sort=True, batch_size=1)
        test_run_validation_ds = model.prepare_validate_dataset(
            prefetch=False, sort=True, batch_size=self.validation_batchsize)
        self.add_log_files(
            test_run_train_dataset=repr(test_run_train_ds),
            test_run_validation_dataset=repr(test_run_validation_ds),
        )
        print('Test run')
        trainer.test_run(test_run_train_ds, test_run_validation_ds,
                         virtual_minibatch_size=1)
        del test_run_train_ds, test_run_validation_ds
        print('Finished test run')

        # Each process pipelines its round-robin share of the examples and
        # batches its share of the global batch; the trainer's step runs on
        # these local rows. drop_last under a mesh: every rank must see as
        # many batches of as many rows (one collective a batch).
        n_proc = multihost.process_count()
        host_shard = trainer.mesh is not None and n_proc > 1
        train_bs, validation_bs = (self.train_batchsize,
                                   self.validation_batchsize)
        if host_shard:
            train_bs //= n_proc
            validation_bs //= n_proc
        validation_ds = model.prepare_validate_dataset(
            prefetch=True, batch_size=validation_bs, host_shard=host_shard,
            drop_last=dp > 1 or host_shard)
        train_ds = model.prepare_train_dataset(
            prefetch=True, batch_size=train_bs, host_shard=host_shard,
            drop_last=dp > 1)
        if self.cache_datasets_on_device:
            print('Caching datasets on device ...')
            validation_ds = validation_ds.copy(freeze=True)
            train_ds = train_ds.copy(freeze=True).shuffle(reshuffle=True)
        trainer.register_validation_hook(
            validation_ds, max_checkpoints=self.max_checkpoints)

        if multihost.process_index() == 0:
            self._add_reports(train_ds, validation_ds)

        print('Train')
        return trainer.train(train_ds, resume=resume)

    def _add_reports(self, train_ds, validation_ds):
        """The reports (the reference's tracker tables), best effort, into
        the log files."""
        model = self.trainer.model
        reports = {}
        try:
            ex = next(iter(model.prepare_validate_dataset(
                prefetch=False, batch_size=self.validation_batchsize)))
            for name, report in (('shapes', track.shape_report),
                                 ('layer_times', track.layer_time_report),
                                 ('cost', track.cost_report)):
                reports[name] = report(model, ex)
        except Exception as e:  # noqa: BLE001 - a report is best-effort
            reports.setdefault('cost', f'report unavailable: {e!r}')
        self.add_log_files(
            train_dataset=repr(train_ds),
            validation_dataset=repr(validation_ds),
            trackers=track.model_report(model),
            **reports,
        )
