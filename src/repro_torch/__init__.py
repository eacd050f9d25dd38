"""PyTorch/CUDA port of :mod:`repro` (ACDC structured efficient linear
layers), written for an NVIDIA H100.

The JAX package ``repro`` stays the reference.  This package mirrors its
module names one for one (``repro_torch.core.acdc`` ports
``repro.core.acdc`` and so on), imports ``torch``, numpy and the standard
library only, and never imports ``jax`` or ``repro``.

Every Pallas TPU kernel on the ported path has a CUDA C++ counterpart in
``csrc/`` (built for ``sm_90a`` by :mod:`repro_torch.kernels.build`); each
kernel wrapper launches it for CUDA tensors and takes its plain PyTorch
version (:mod:`repro_torch.kernels.ref`) for CPU tensors only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

Precision: float32 matrix products and convolutions must not silently
drop to TF32 (the reference computes in full fp32), so importing this
package sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` for the process.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"
