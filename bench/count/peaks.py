"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), the yardstick
every roofline share and ``mfu`` is divided by.

NVIDIA's data sheet gives the dense rates (no sparsity) at the card's
full power limit of 700 W; a card set below it runs slower under load,
so every run records ``power.limit`` beside its numbers
(``nvidia-smi --query-gpu=name,power.limit``) and the shares stay
against these published peaks.
"""

#: dense bf16 tensor-core rate, FLOP/s: the peak of ``mfu.*``
BF16_FLOPS = 989e12
#: dense TF32 tensor-core rate, FLOP/s: no fp32-accurate product runs
#: faster (a 3xTF32 product takes three of them), so a kernel's
#: operations are bounded against it
TF32_FLOPS = 495e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES_S = 3.35e12
#: the power limit these peaks assume, W
POWER_LIMIT_W = 700.0
