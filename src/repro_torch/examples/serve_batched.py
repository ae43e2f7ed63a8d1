"""Batched serving demo: prefill a request batch, decode continuations with
the same step functions the production dry run traces at 32k/500k shapes.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched --arch zamba2-1.2b [--device cpu]

Every other flag goes to `repro_torch.launch.serve` after this demo's sizes
(8 requests of 32 prompt tokens, 16 new ones, the reduced config), so a
later one wins: `--requests 2` serves two.
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve


def main(argv=None) -> serve.ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b")
    args, rest = ap.parse_known_args(argv)
    return serve.main(["--arch", args.arch, "--reduced", "--requests", "8",
                       "--prompt-len", "32", "--max-new", "16", *rest])


if __name__ == "__main__":
    main()
