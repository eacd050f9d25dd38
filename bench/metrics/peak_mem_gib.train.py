"""``peak_mem_gib.train``: ``torch.cuda.max_memory_allocated`` over the
window, its counter reset after set-up, in GiB."""


def read(art):
    if art.get("kind") != "train" or not art.get("window_peak_bytes"):
        return None
    return art["window_peak_bytes"] / 2 ** 30
