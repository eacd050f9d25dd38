"""Paper section 6.2 mechanism on PyTorch, offline proxy: replace the FC
layers of a small convnet with a 12-layer ACDC+ReLU+permutation stack and
train on a synthetic image-classification task (the port of
``examples/convnet_acdc.py``).

    PYTHONPATH=src python examples/convnet_acdc_torch.py [--fc dense|acdc] \\
        [--steps 300] [--device cpu]

Every mechanism of the paper's experiment: the 12-deep SELL stack,
identity+noise init, bias-on-D, lr multipliers (x24 A, x12 D), no weight
decay on the diagonals, and the parameter bookkeeping.  The parameters
keep the reference's layout (images NHWC, convolutions HWIO, features
flattened in NHWC order), so one set of weights runs in both.
"""

import argparse
import time

import torch
import torch.nn.functional as F

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import acdc as A
from repro_torch.optim import OptimizerConfig, make_optimizer, \
    step_decay_schedule, tree_map

N_CLASSES = 10
IMG = 16
N_FEAT = 8 * (IMG // 2) * (IMG // 2)   # 512: 8 channels of 8 x 8
#: the paper's optimizer groups: lr x24 on A, x12 on D, no weight decay
#: on the diagonals and the bias
GROUPS = ((r"sell/a$", {"lr_mult": 24.0, "weight_decay": 0.0}),
          (r"sell/d$", {"lr_mult": 12.0, "weight_decay": 0.0}),
          (r"sell/bias$", {"weight_decay": 0.0}))


def acdc_config(k: int = 12) -> A.ACDCConfig:
    return A.ACDCConfig(n=N_FEAT, k=k, relu=True, permute=True, bias=True,
                        init_std=0.061)


def synth_images(gen: torch.Generator, n: int, n_classes: int = N_CLASSES,
                 device=DEFAULT_DEVICE) -> tuple:
    """Class-conditional Gabor-ish patterns + noise, (n, IMG, IMG, 1) NHWC
    and labels: the reference's distribution, drawn from ``gen``."""
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=device)
    yy, xx = torch.meshgrid(torch.arange(IMG, device=device),
                            torch.arange(IMG, device=device), indexing="ij")
    freqs = (1 + torch.arange(n_classes, dtype=torch.float32,
                              device=device)) / n_classes
    base = torch.sin(freqs[:, None, None] * (xx + 2 * yy)[None] * 0.8)
    x = base[labels] + 0.3 * torch.randn((n, IMG, IMG), generator=gen,
                                         device=device)
    return x[..., None], labels


def init_model(gen: torch.Generator, fc_kind: str = "acdc", k: int = 12,
               device=DEFAULT_DEVICE) -> dict:
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    p = {"conv1": 0.1 * randn(3, 3, 1, 8), "conv2": 0.1 * randn(3, 3, 8, 8)}
    if fc_kind == "dense":
        p["fc1"] = {"w": 0.05 * randn(N_FEAT, N_FEAT),
                    "b": torch.zeros(N_FEAT, device=device)}
    else:
        cfg = A.ACDCConfig(n=N_FEAT, k=k, relu=True, permute=True, bias=True,
                           init_mean=1.0, init_std=0.061)  # paper's init
        p["sell"] = A.init_acdc_params(gen, cfg, device=device)
    p["out"] = {"w": 0.05 * randn(N_FEAT, N_CLASSES),
                "b": torch.zeros(N_CLASSES, device=device)}
    return p


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """An NHWC x HWIO convolution with the reference's "SAME" padding: a
    3 x 3 kernel pads (1, 1) at stride 1 and (0, 1) at stride 2 on an even
    size (torch's ``padding=1`` would pad (1, 1) there too)."""
    h = x.permute(0, 3, 1, 2)
    size = h.shape[-1]
    out = -(-size // stride)
    total = max((out - 1) * stride + w.shape[0] - size, 0)
    lo = total // 2
    h = F.pad(h, (lo, total - lo, lo, total - lo))
    h = F.conv2d(h, w.permute(3, 2, 0, 1), stride=stride)
    return h.permute(0, 2, 3, 1)


def forward(p: dict, x: torch.Tensor, fc_kind: str,
            cfg: A.ACDCConfig) -> torch.Tensor:
    h = torch.relu(_conv(x, p["conv1"], 1))
    h = torch.relu(_conv(h, p["conv2"], 2))
    h = h.reshape(h.shape[0], -1)       # NHWC order, as the reference's
    h = h * 0.1  # paper: scale features into the SELL by 0.1
    if fc_kind == "dense":
        h = torch.relu(h @ p["fc1"]["w"] + p["fc1"]["b"])
    else:
        h = torch.relu(A.acdc_cascade(p["sell"], h, cfg))
    return h @ p["out"]["w"] + p["out"]["b"]


def make_opt(steps: int):
    """The paper's optimizer: SGD momentum 0.65, step decay, lr mults."""
    return make_optimizer(
        OptimizerConfig(kind="sgd", lr=1.0, momentum=0.65,
                        weight_decay=5e-4, grad_clip=1.0, groups=GROUPS),
        step_decay_schedule(1e-3, 0.1, max(steps // 2, 1)))


def _leaves(tree: dict) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def train_step(p: dict, opt_state: dict, opt, x: torch.Tensor,
               y: torch.Tensor, i: int, fc_kind: str,
               cfg: A.ACDCConfig) -> tuple:
    """(params, opt state, loss, accuracy) after one SGD step on (x, y)."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
    logits = forward(leaves, x, fc_kind, cfg)
    loss = -torch.mean(torch.log_softmax(logits, -1)
                       .gather(1, y[:, None].long()))
    grads = iter(torch.autograd.grad(loss, _leaves(leaves)))
    g = tree_map(lambda _: next(grads), leaves)
    acc = torch.mean((logits.argmax(-1) == y).float())
    u, opt_state = opt.update(g, opt_state, p, i)
    p = tree_map(lambda a, b: (a + b).detach(), p, u)
    return p, opt_state, loss.detach(), acc


def accuracy(p: dict, x: torch.Tensor, y: torch.Tensor, fc_kind: str,
             cfg: A.ACDCConfig) -> float:
    with torch.no_grad():
        logits = forward(p, x, fc_kind, cfg)
    return float(torch.mean((logits.argmax(-1) == y).float()))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fc", default="acdc", choices=["acdc", "dense"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--k", type=int, default=12)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    dev = args.device

    gen = torch.Generator(device=dev).manual_seed(0)
    p = init_model(gen, args.fc, args.k, dev)
    cfg = acdc_config(args.k)
    n_params = sum(t.numel() for t in _leaves(p))
    fc_params = (N_FEAT * N_FEAT + N_FEAT if args.fc == "dense"
                 else cfg.param_count())
    print(f"fc={args.fc}: total params {n_params:,} "
          f"(fc block: {fc_params:,})")

    opt = make_opt(args.steps)
    opt_state = opt.init(p)
    data = torch.Generator(device=dev).manual_seed(1)
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        x, y = synth_images(data, args.batch, device=dev)
        p, opt_state, loss, acc = train_step(p, opt_state, opt, x, y, i,
                                             args.fc, cfg)
        losses.append(float(loss))
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {losses[-1]:.4f} acc {float(acc):.3f} "
                  f"({time.time() - t0:.0f}s)")
    xe, ye = synth_images(torch.Generator(device=dev).manual_seed(123), 512,
                          device=dev)
    acc = accuracy(p, xe, ye, args.fc, cfg)
    print(f"eval acc: {acc:.3f}")
    return dict(n_params=n_params, losses=losses, eval_acc=acc,
                seconds=time.time() - t0)


if __name__ == "__main__":
    main()
