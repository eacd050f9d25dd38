"""``idle_share.train``: the share of the traced steps' span in which no
kernel, copy or set ran on the card, in %."""


def read(art):
    t = art.get("trace")
    if art.get("kind") != "train" or not t or t["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])
