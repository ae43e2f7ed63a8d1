"""The benchmark's plain reference: float32 models of its configurations
(`models`, one module a family under `families/`, and the `layers` they
share), the methods and update rules it trains them with (`train`,
`methods/`, `optimizers/`), and the lower-precision products of the
correctness check's control (`precision`). It imports nothing but `torch`
and the benchmark's own modules, nothing of the program."""
