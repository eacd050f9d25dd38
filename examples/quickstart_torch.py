"""Quickstart on PyTorch: the ACDC structured efficient linear layer in 60
seconds (the port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Shows: (1) a single ACDC layer and its O(N) parameter count, (2) a deep
cascade approximating a dense matrix, (3) dropping ACDC into a projection
of any shape, (4) the fused kernel (on the card the Hopper ``acdc_fused``
kernel; on CPU tensors its plain version), (5) ACDC inside a model.  Each
section is a function of explicit tensors, so the same weights can be fed
to the JAX quickstart and this one.
"""

import argparse
import dataclasses

import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.configs import registry
from repro_torch.core import acdc as A
from repro_torch.core.sell import SellConfig, init_sell_params, \
    structured_linear
from repro_torch.kernels import ops
from repro_torch.models import get_model

N = 512
CFG1 = A.ACDCConfig(n=N, k=1)
CFG12 = A.ACDCConfig(n=N, k=12, relu=True, permute=True)
SELL = SellConfig(kind="acdc", n_in=768, n_out=3072, k=2, lane_multiple=128)
#: the fused kernel's call: M rows of N = 256, fp32
KERNEL_M, KERNEL_N = 16, 256


def n_params(tree: dict) -> int:
    return sum(v.numel() if isinstance(v, torch.Tensor) else n_params(v)
               for v in tree.values())


def model_config():
    """[5]'s model: smoke Qwen3 with order-2 ACDC projections (``auto``)."""
    return dataclasses.replace(registry.get_smoke_config("qwen3_1_7b"),
                               sell_kind="acdc", sell_k=2)


def layer(params: dict, x: torch.Tensor) -> torch.Tensor:
    """[1] one ACDC layer ``y = (x*a) C diag(d) C^T``."""
    return A.acdc_cascade(params, x, CFG1)


def cascade(params: dict, x: torch.Tensor) -> torch.Tensor:
    """[2] the 12-layer ACDC + ReLU + riffle stack."""
    return A.acdc_cascade(params, x, CFG12)


def projection(params: dict, x: torch.Tensor) -> torch.Tensor:
    """[3] a rectangular 768 -> 3072 ACDC projection (pad / truncate)."""
    return structured_linear(params, x, SELL)


def fused(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor) -> tuple:
    """[4] the fused kernel and the matmul route on the same inputs:
    (kernel's y, reference y, max |err|)."""
    yk = ops.acdc_fused_op(x, a, d, None)
    yr = A.acdc(x, a, d, method="matmul")
    return yk, yr, float((yk - yr).abs().max())


def model_logits(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """[5] the model's logits of ``tokens``."""
    cfg = model_config()
    return get_model(cfg).apply(params, tokens, cfg)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    dev = args.device
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    out = {}
    p1 = A.init_acdc_params(gen, CFG1, device=dev)
    x = randn(8, N)
    y = layer(p1, x)
    n1 = n_params(p1)
    print(f"[1] ACDC layer N={N}: {n1} params (dense would use {N * N}) -> "
          f"{N * N // n1}x smaller; y shape {tuple(y.shape)}")

    p12 = A.init_acdc_params(gen, CFG12, device=dev)
    y12 = cascade(p12, x)
    print(f"[2] 12-layer ACDC+ReLU+perm stack (the CaffeNet replacement): "
          f"{CFG12.param_count()} params, output {tuple(y12.shape)}")

    sp = init_sell_params(gen, SELL, device=dev)
    h = projection(sp, randn(4, 768))
    print(f"[3] rectangular 768->3072 ACDC (pad/truncate): {tuple(h.shape)}"
          f", {SELL.param_count()} params vs dense {768 * 3072}")

    a = 1 + 0.1 * randn(KERNEL_N)
    d = 1 + 0.1 * randn(KERNEL_N)
    xk = randn(KERNEL_M, KERNEL_N)
    yk, yr, err = fused(xk, a, d)
    print(f"[4] fused kernel vs reference: max |err| = {err:.2e}")

    cfg = model_config()
    params = get_model(cfg).init(gen, cfg, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                         device=dev)
    logits = model_logits(params, toks)
    print(f"[5] qwen3-smoke with ACDC projections: logits "
          f"{tuple(logits.shape)}, finite={bool(torch.isfinite(logits).all())}")
    out.update(params=(n1, CFG12.param_count(), SELL.param_count()),
               fused=(xk, a, d, yk, err), logits=logits)
    return out


if __name__ == "__main__":
    main()
