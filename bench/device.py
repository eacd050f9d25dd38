"""Device helpers that are no-ops on the CPU, where the tests and the
rehearsals run a cell through the harness's functions at smoke size."""

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak(device) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
