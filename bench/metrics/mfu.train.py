"""``mfu.train``: the window's counted model FLOPs (``bench.count.flops``,
three forwards a step) over its seconds and the card's dense bf16 peak,
in %."""

from bench.count import peaks


def read(art):
    if art.get("kind") != "train" or not art.get("steps"):
        return None
    flops = art["steps"] * art["flops_per_step"]
    return 100.0 * flops / (art["window_s"] * peaks.BF16_FLOPS)
