"""Checkpoints: port of ``tssep_tpu/train/checkpoint.py``, in its file format,
so each package reads the other's files.

- model parameters under their dotted names (``model/mask_estimator.
  post_net.linear2.weight``): the JAX package's params-tree paths are the
  port's ``state_dict`` names, so cross-task warm starts (the VAD->SEP
  broadcast) address parameters by name and either package loads the
  other's parameters;
- the optimizer state's tensors as ``opt/<i:05d>`` in a fixed order; the
  port also writes, in ``__meta__``, the layout that puts them back into
  its optimizer (``opt_layout``). The JAX package restores ``opt/`` into an
  optax state of the same leaf count only, so each package restores only
  its own optimizer state and starts the other's afresh;
- ``__meta__``: JSON (iteration, best validation loss, patience counter);
- ``ckpt_<it>.npz`` with ``ckpt_latest.npz`` / ``ckpt_best_loss.npz``
  symlinks; an optional single background writer (``async_write``) and
  ``write=False``, which writes nothing: the data ranks other than 0 pass
  it (their parameters are rank 0's, so there is nothing to gather).
"""

from __future__ import annotations

import io
import json
import queue
import threading
from pathlib import Path

import numpy as np
import torch

__all__ = ['save_checkpoint', 'load_checkpoint', 'params_to_named',
           'named_to_params', 'latest_checkpoint', 'wait_for_pending',
           'optimizer_state', 'load_optimizer_state']


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def params_to_named(model: torch.nn.Module) -> dict:
    """``{dotted_name: np.ndarray}`` of ``model``'s parameters."""
    return {name: _to_numpy(value)
            for name, value in model.state_dict().items()}


def named_to_params(named: dict, model: torch.nn.Module,
                    strict: bool = True):
    """Copies ``named`` into ``model``'s parameters in place. ``strict``:
    every parameter must be there with its shape; else missing names keep
    their values. Raises ``KeyError`` / ``ValueError`` as the JAX
    ``named_to_params`` does."""
    state = model.state_dict()
    missing = [n for n in state if n not in named]
    if missing and strict:
        raise KeyError(f'Checkpoint is missing parameters: {missing}')
    for name, old in state.items():
        if name not in named:
            continue
        new = np.asarray(named[name])
        if new.shape != tuple(old.shape):
            raise ValueError(f'Shape mismatch for {name}: ckpt {new.shape} '
                             f'vs model {tuple(old.shape)}')
        with torch.no_grad():
            old.copy_(torch.from_numpy(np.array(new)))
    return model


# -- the optimizer's state as a list of arrays and a JSON layout ------------

def _flatten_state(obj, tensors):
    """``obj`` (a state dict) as JSON with each tensor replaced by its index
    in ``tensors``; dicts keep their key types as lists of pairs."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return {'tensor': len(tensors) - 1}
    if isinstance(obj, dict):
        return {'dict': [[k, _flatten_state(v, tensors)]
                         for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        return {'list': [_flatten_state(v, tensors) for v in obj]}
    return {'value': obj}


def _unflatten_state(layout, arrays):
    if 'tensor' in layout:
        return torch.from_numpy(np.array(arrays[layout['tensor']]))
    if 'dict' in layout:
        return {k: _unflatten_state(v, arrays) for k, v in layout['dict']}
    if 'list' in layout:
        return [_unflatten_state(v, arrays) for v in layout['list']]
    return layout['value']


def optimizer_state(optimizer):
    """(list of arrays, JSON layout) of ``optimizer.state_dict()``."""
    tensors = []
    layout = _flatten_state(optimizer.state_dict(), tensors)
    return [_to_numpy(t) for t in tensors], layout


def load_optimizer_state(optimizer, arrays, layout):
    optimizer.load_state_dict(_unflatten_state(layout, arrays))


# -- writing ----------------------------------------------------------------

class _AsyncWriter:
    """Single background worker serializing checkpoint writes in order: the
    device->host copy happens in ``save_checkpoint``, the npz serialization,
    the disk write and the symlinks here. ``wait()`` drains the queue."""

    def __init__(self):
        self._q = queue.Queue()
        self._err = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is not None:
                    path, payload, best, after = item
                    _write_payload(path, payload, best)
                    if after is not None:
                        after()
            except Exception as e:  # noqa: BLE001 - surfaced by wait()
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, *item):
        self.check()
        self._q.put(item)

    def wait(self):
        self._q.join()
        self.check()

    def check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError('async checkpoint write failed') from err


_ASYNC_WRITER = None


def _async_writer() -> _AsyncWriter:
    global _ASYNC_WRITER
    if _ASYNC_WRITER is None:
        _ASYNC_WRITER = _AsyncWriter()
    return _ASYNC_WRITER


def wait_for_pending():
    """Block until queued async checkpoint writes have hit the disk."""
    if _ASYNC_WRITER is not None:
        _ASYNC_WRITER.wait()


def _write_payload(path: Path, payload: dict, best: bool):
    buf = io.BytesIO()
    np.savez(buf, **payload)
    tmp = path.with_suffix('.tmp')
    tmp.write_bytes(buf.getvalue())
    tmp.replace(path)
    _relink(path.parent / 'ckpt_latest.npz', path)
    if best:
        _relink(path.parent / 'ckpt_best_loss.npz', path)


def save_checkpoint(ckpt_dir, iteration, model, optimizer=None, meta=None,
                    best=False, async_write=False, write=True,
                    after_write=None):
    """Writes ``ckpt_<iteration>.npz`` (``model``'s parameters, the
    optimizer's state, ``meta``) and relinks ``ckpt_latest.npz`` (and
    ``ckpt_best_loss.npz`` with ``best``). ``model`` is a module or a
    ``{name: array}`` dict. ``write=False`` copies nothing and writes
    nothing; ``after_write`` runs once the file and the links are on disk
    (in the writer thread with ``async_write``)."""
    if not write:
        return None
    ckpt_dir = Path(ckpt_dir)
    named = (model if isinstance(model, dict) else params_to_named(model))
    payload = {f'model/{name}': _to_numpy(arr) for name, arr in named.items()}
    meta = dict(meta or {})
    if optimizer is not None:
        arrays, meta['opt_layout'] = optimizer_state(optimizer)
        for i, arr in enumerate(arrays):
            payload[f'opt/{i:05d}'] = arr
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    meta['iteration'] = int(iteration)
    payload['__meta__'] = np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8)

    path = ckpt_dir / f'ckpt_{iteration}.npz'
    if async_write:
        _async_writer().submit(path, payload, best, after_write)
    else:
        _write_payload(path, payload, best)
    return path


def _relink(link: Path, target: Path):
    if link.is_symlink() or link.exists():
        link.unlink()
    link.symlink_to(target.name)


def load_checkpoint(path, model=None, optimizer=None):
    """Returns (named parameters, optimizer arrays or None, meta). With
    ``model``, copies the parameters into it (strictly); with
    ``optimizer``, restores its state where the file holds the port's
    layout for it."""
    path = Path(path)
    with np.load(path, allow_pickle=False) as z:
        names = list(z.files)
        meta = {}
        if '__meta__' in names:
            meta = json.loads(bytes(z['__meta__']).decode())
        named = {n[len('model/'):]: z[n] for n in names
                 if n.startswith('model/')}
        opt_arrays = [z[n] for n in sorted(names) if n.startswith('opt/')]
    if model is not None:
        named_to_params(named, model)
    if optimizer is not None and opt_arrays and 'opt_layout' in meta:
        load_optimizer_state(optimizer, opt_arrays, meta['opt_layout'])
    return named, (opt_arrays or None), meta


def latest_checkpoint(ckpt_dir):
    p = Path(ckpt_dir) / 'ckpt_latest.npz'
    return p if p.exists() else None
