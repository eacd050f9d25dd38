"""Batched serving example on PyTorch: prefill + decode with a KV cache on
any arch (the port of ``examples/serve_lm.py``).

    PYTHONPATH=src python examples/serve_lm_torch.py --arch mamba2_1_3b \\
        --smoke [--device cpu]

Every argument goes to ``repro_torch.launch.serve``; with none, smoke
Qwen3 serves 4 slots of 16-token prompts for 24 tokens each.
"""

import sys

from repro_torch.launch import serve as serve_mod

DEFAULT_ARGV = ["--arch", "qwen3_1_7b", "--smoke", "--batch", "4",
                "--prompt-len", "16", "--gen", "24"]


def main(argv=None):
    """Serve; returns the launcher's result (the engine and its
    requests)."""
    argv = sys.argv[1:] if argv is None else argv
    return serve_mod.main(argv or DEFAULT_ARGV)


if __name__ == "__main__":
    main()
