"""The training loop of the flagship's step: port of the part of
``tssep_tpu/train/trainer.py`` that ``bench.py``'s ``train_step`` runs
(``Trainer.__init__`` :173-226, ``train`` :615-700).

``train_step`` runs ``Model.loss_fn`` with ``training=True``, the backward
(the BLSTM layers' backward kernels among it), the gradient clip and the
Adam update, and returns the loss as a tensor without waiting for the card.
``train`` runs a number of steps, reads the losses back once at the end and
raises on a non-finite one, as the JAX trainer does when it drains its
pending losses. With ``virtual_minibatch_size`` k, each step is one of k
micro-batches whose gradients ``MultiSteps`` averages; the parameters change
on every k-th step.

Checkpoints, validation, summaries, snapshots and the mesh are not ported
yet.
"""

from __future__ import annotations

import itertools
import math

import torch

from tssep_tpu_torch.train.optimizer import Adam

__all__ = ['Trainer']


class Trainer:
    """``Trainer(model, optimizer, seed, virtual_minibatch_size)``;
    ``optimizer`` is an :class:`Adam` or ``SGD`` configuration (default:
    Adam, clipping 10, lr 1e-3). The random speaker order and dropout draw
    from a generator on the model's device seeded with ``seed``."""

    def __init__(self, model, optimizer: Adam | None = None, seed: int = 0,
                 virtual_minibatch_size: int = 1):
        self.model = model
        self.virtual_minibatch_size = int(virtual_minibatch_size)
        self.optimizer = (optimizer or Adam()).make(
            model.parameters(), self.virtual_minibatch_size)
        self.seed = seed
        self.generator = torch.Generator(device=model.device).manual_seed(seed)
        self.iteration = 0

    def train_step(self, batch: dict) -> torch.Tensor:
        """One optimizer step on ``batch``; returns the loss, still on the
        device."""
        self.optimizer.zero_grad()
        loss, _ = self.model.loss_fn(batch, self.generator, training=True)
        loss.backward()
        self.optimizer.step()
        self.iteration += 1
        return loss.detach()

    def train(self, dataset, num_steps: int) -> list[float]:
        """``num_steps`` steps on batches from ``dataset``; returns the
        losses. Raises ``RuntimeError`` on a non-finite loss."""
        losses = [self.train_step(batch)
                  for batch in itertools.islice(dataset, num_steps)]
        first = self.iteration - len(losses)
        values = torch.stack(losses).tolist() if losses else []
        for i, value in enumerate(values):
            if not math.isfinite(value):
                raise RuntimeError(f'Non-finite loss {value} near iteration '
                                   f'{first + i}')
        return values
