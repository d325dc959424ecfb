"""Float32 matmul precision policy: no TF32 anywhere in the solver.

Counterpart of ``collocfem_tpu/ops/einsum_hp.py``, which pins JAX's TPU
contractions to ``Precision.HIGHEST``: the TPU's default bf16 passes
destroyed the Gauss-Newton system.  On the GPU the same failure mode is
TF32 (about three decimal digits) on the normal-equation contractions, so
the package turns it off for matmuls and cuDNN when it is imported.
"""

from __future__ import annotations

import torch


def apply() -> None:
    """Pin float32 matmuls and convolutions to full float32 precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
