"""The port's one numerics setting for fp32 work on the card.

PyTorch runs fp32 matrix products in full fp32 by default, but fp32 cuDNN
convolutions in TF32 (``torch.backends.cudnn.allow_tf32`` is True), which
keeps about three decimal digits. The JAX package's reference numbers are
full fp32, so every entry point of the port calls :func:`full_fp32` before
it computes, whichever entry point a process reaches first. The setting is
process-wide, as PyTorch's flags are; bf16 work is unaffected.
"""

from __future__ import annotations

import torch


def full_fp32() -> None:
    """fp32 products and cuDNN convolutions in full fp32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
