"""The traffic generator and the weights: the same seed gives the same
batches and leaves, another seed other ones."""

import torch

from bench.traffic import train
from bench.weights import make_leaf

CFG = {"vocab_size": 1000, "d_model": 32, "sell_init_std": 0.061}
TRAIN = {"rows": 2, "seq": 16, "frames": 4, "n_batches": 3, "zipf_a": 1.2,
         "markov": 0.5}
CPU = torch.device("cpu")


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_train_batches_follow_the_seed():
    a = train.batches(TRAIN, CFG, 2 ** 31 + 5, CPU)
    b = train.batches(TRAIN, CFG, 2 ** 31 + 5, CPU)
    c = train.batches(TRAIN, CFG, 2 ** 31 + 6, CPU)
    assert all(_same(x, y) for x, y in zip(a, b))
    assert not any(_same(x, y) for x, y in zip(a, c))
    assert not _same(a[0], a[1])               # the rows of steps differ
    assert torch.equal(a[0]["labels"][:, :-1], a[0]["tokens"][:, 1:])
    assert (a[0]["labels"][:, -1] == -1).all()
    assert a[0]["frontend_embeds"].shape == (2, 4, 32)
    assert train.tokens_per_step(TRAIN) == 2 * (16 + 4)


def test_weights_follow_the_seed_leaf_by_leaf():
    a = make_leaf("layers/attn/wq/w", (2, 8, 4), 9, CFG, CPU)
    b = make_leaf("layers/attn/wq/w", (2, 8, 4), 9, CFG, CPU)
    c = make_leaf("layers/attn/wq/w", (2, 8, 4), 10, CFG, CPU)
    d = make_leaf("layers/attn/wk/w", (2, 8, 4), 9, CFG, CPU)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, d)
    diag = make_leaf("layers/mlp/wg/sell/a", (2, 2, 64), 9, CFG, CPU)
    assert abs(float(diag.mean()) - 1.0) < 0.05
    assert make_leaf("layers/norm1/scale", (2, 8), 9, CFG, CPU).abs().sum() == 0
