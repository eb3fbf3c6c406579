"""PyTorch and CUDA port of ``tssep_tpu`` for an NVIDIA H100.

Imports neither JAX nor anything of ``tssep_tpu``. Entry points run on the
card (``device='cuda'``) unless the caller passes ``device='cpu'``.
"""

from tssep_tpu_torch.utils.device import resolve_device  # noqa: F401
