"""Paper section 6.1 on PyTorch: recover a dense operator with ACDC
cascades (Fig. 3; the port of ``examples/linear_recovery.py``).

    PYTHONPATH=src python examples/linear_recovery_torch.py [--ks 1,4,16] \\
        [--steps 3000] [--init good|bad|both] [--device cpu]

Prints the final train MSE per K; ``--init bad`` reproduces the failure
mode of the standard N(0, sigma) initialization on deep cascades (Fig. 3
right).  The problem and the trainer are this file's own copies of
``benchmarks/bench_fig3_recovery.py``'s ``make_problem`` and ``train``:
X in R^{10000 x 32} ~ U[0, 1], W_true 32 x 32 ~ U[0, 1], targets with
N(0, 1e-4) noise; full-batch Adam written out (beta 0.9 / 0.999, bias
correction) on a cosine learning rate from 2e-2.
"""

import argparse
import math

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import acdc as A

N = 32
KS = (1, 2, 4, 8, 16, 32)
GOOD = dict(init_mean=1.0, init_std=1e-1)
BAD = dict(init_mean=0.0, init_std=1e-3)


def make_problem(m: int = 10_000, seed: int = 0, device=DEFAULT_DEVICE):
    """(x, y, w_true) drawn from ``np.random.RandomState(seed)``, as the
    reference draws them."""
    r = np.random.RandomState(seed)
    x = r.rand(m, N).astype(np.float32)
    w = r.rand(N, N).astype(np.float32)
    # the noise term is float64 in numpy; the reference's jnp.asarray
    # rounds the sum to float32, as astype does
    y = (x @ w + np.sqrt(1e-4) * r.randn(m, N).astype(np.float32)
         ).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x, y, w))


def mse(params: dict, x: torch.Tensor, y: torch.Tensor,
        cfg: A.ACDCConfig) -> torch.Tensor:
    return torch.mean((A.acdc_cascade(params, x, cfg) - y) ** 2)


def train(cfg: A.ACDCConfig, x: torch.Tensor, y: torch.Tensor,
          steps: int = 3000, lr0: float = 2e-2, seed: int = 0,
          params: dict = None) -> tuple:
    """(final MSE, each step's loss before its update): ``steps`` Adam
    steps on the full batch from ``params`` (default: drawn from a
    generator seeded ``seed``)."""
    if params is None:
        gen = torch.Generator(device=x.device).manual_seed(seed)
        params = A.init_acdc_params(gen, cfg, device=x.device)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    losses = []
    for i in range(steps):
        lr = lr0 * 0.5 * (1 + math.cos(math.pi * i / steps))
        loss = mse(p, x, y, cfg)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        losses.append(loss.detach())
        with torch.no_grad():
            for k, g in grads.items():
                m[k].mul_(0.9).add_(0.1 * g)
                v[k].mul_(0.999).add_(0.001 * g * g)
                mh = m[k] / (1 - 0.9 ** (i + 1.0))
                vh = v[k] / (1 - 0.999 ** (i + 1.0))
                p[k].sub_(lr * mh / (torch.sqrt(vh) + 1e-8))
    with torch.no_grad():
        final = float(mse(p, x, y, cfg))
    return final, torch.stack(losses).cpu() if losses else torch.empty(0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ks", default="1,2,4,8,16,32")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--init", default="good", choices=["good", "bad", "both"])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    ks = [int(k) for k in args.ks.split(",")]

    x, y, w = make_problem(device=args.device)
    floor = float(torch.mean((y - x @ w) ** 2))
    print(f"noise floor (dense W_true): {floor:.6f}")
    out = {"floor": floor}
    for k in ks:
        for name, init, label in (("good", GOOD, "N(1,1e-1)"),
                                  ("bad", BAD, "N(0,1e-3)")):
            if args.init not in (name, "both"):
                continue
            loss, _ = train(A.ACDCConfig(n=N, k=k, bias=True, **init), x, y,
                            steps=args.steps)
            out[(k, name)] = loss
            print(f"K={k:2d}  init {label}: final MSE {loss:.6f}")
    return out


if __name__ == "__main__":
    main()
