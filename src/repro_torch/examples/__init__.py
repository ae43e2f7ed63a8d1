"""The user scripts of the port (counterparts of the repository's
`examples/`), each a module run as `python -m repro_torch.examples.<name>`:
`quickstart`, `hetero_async_sam`, `remote_ascent`, `serve_batched` and
`train_100m`. Each takes the reference script's flags and default sizes,
and `--device` (default `cuda`; a run asked for on the card raises where
there is none, and `--device cpu` runs on the CPU). Each `main(argv)`
returns what it printed as numbers, and takes keyword-only sizes, which
the tests use to run it small.
"""
