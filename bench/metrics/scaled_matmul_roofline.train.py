"""``scaled_matmul_roofline.train``: the sum of every ``scaled_matmul``
launch's bound (``bench.count.kernels``) over the sum of their device
time in the traced steps, in %.  Nothing is read when the traced
launches differ from the inventory the bounds were counted for."""

from bench.metrics_common import roofline


def read(art):
    if art.get("kind") != "train":
        return None
    return roofline(art, "scaled_matmul")
