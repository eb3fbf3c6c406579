"""Load the JAX package's parameters into the port.

``tssep_tpu`` names every parameter by its dotted path in the params tree
(``train/checkpoint.py:51-57`` ``params_to_named``), for example
``mask_estimator.post_net.birnn0.lstm0.weight_ih_l0``, and keeps torch's
layouts. The port's modules carry the same names, so a named dict loads with
``load_state_dict``. Checkpoints store the model's entries under ``model/``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['load_named', 'load_npz']


def load_named(model: torch.nn.Module, named: dict) -> torch.nn.Module:
    """Copy ``{dotted_name: array}`` into ``model``'s parameters; raises on a
    missing or unexpected name or a shape mismatch."""
    model.load_state_dict(
        {name: torch.from_numpy(np.array(value)) for name, value in
         named.items()}, strict=True)
    return model


def load_npz(path) -> dict:
    """The named parameters of a ``tssep_tpu`` checkpoint (``ckpt_*.npz``)."""
    prefix = 'model/'
    with np.load(path, allow_pickle=False) as z:
        return {name[len(prefix):]: z[name] for name in z.files
                if name.startswith(prefix)}
