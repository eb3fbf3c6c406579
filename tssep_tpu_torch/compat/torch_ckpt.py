"""Import checkpoints saved by the torch reference: port of
``tssep_tpu/compat/torch_ckpt.py``.

The reference saves ``{'model': state_dict, ...}`` .pth files
(``init_ckpt.py:27-30``). The port's parameters keep torch tensor layouts
(LSTM ``weight_ih_l0`` (4H, I) with i,f,g,o gate order; Linear (out, in)),
so a reference checkpoint maps onto the model bit for bit; only the module
names differ:

    mask_estimator.pre_net.net.0.weight_ih_l0 -> ...pre_net.lstm0.weight_ih_l0
    mask_estimator.pre_net.net.1.weight       -> ...pre_net.proj0.weight
    mask_estimator.post_net.birnnK.net.0.*    -> ...post_net.birnnK.lstm0.*
    mask_estimator.post_net.birnnK.net.1.*    -> ...post_net.birnnK.proj0.*
    mask_estimator.post_net.linearK.*         -> unchanged
    mask_estimator.aux_net.net.{0,2,4}.*      -> ...aux_net.linear{0,1,2}.*
"""

from __future__ import annotations

import re

import numpy as np

import torch

from tssep_tpu_torch.train.checkpoint import named_to_params

__all__ = ['translate_torch_name', 'load_torch_state_dict',
           'torch_checkpoint_to_named', 'load_torch_checkpoint']


def translate_torch_name(name: str) -> str:
    """Reference state_dict key -> the port's dotted parameter name."""
    # RNNP blocks: net.0 = LSTM, net.1 = projection Linear
    name = re.sub(r'\.net\.0\.(weight_ih|weight_hh|bias_ih|bias_hh)',
                  r'.lstm0.\1', name)
    name = re.sub(r'\.net\.1\.(weight|bias)$', r'.proj0.\1', name)
    # Multi-layer RNNP (elayers > 1): net.(4k) lstm, net.(4k+1) proj
    m = re.match(r'(.*)\.net\.(\d+)\.(.*)', name)
    if m:
        prefix, idx, rest = m.group(1), int(m.group(2)), m.group(3)
        if rest.startswith(('weight_ih', 'weight_hh', 'bias_ih', 'bias_hh')):
            name = f'{prefix}.lstm{idx // 4}.{rest}'
        elif 'aux_net' in prefix:
            # AuxNet MLP: linears at even indices (ReLUs between)
            name = f'{prefix}.linear{idx // 2}.{rest}'
        else:
            name = f'{prefix}.proj{idx // 4}.{rest}'
    return name


def load_torch_state_dict(path):
    """Load a torch .pth checkpoint's model state dict as numpy arrays."""
    state = torch.load(str(path), map_location='cpu', weights_only=False)
    if isinstance(state, dict) and 'model' in state:
        state = state['model']
    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in state.items()}


def torch_checkpoint_to_named(path) -> dict:
    """-> {the port's dotted name: np.ndarray}."""
    return {translate_torch_name(k): v
            for k, v in load_torch_state_dict(path).items()}


def load_torch_checkpoint(path, model):
    """Load a reference .pth checkpoint into ``model`` (strictly)."""
    return named_to_params(torch_checkpoint_to_named(path), model)
