"""The weight space's dot product and two sums of squares of two buffers
(three fp32 results). Bytes only, no operations counted: every argument
read once but those only written, the buffers it writes written once."""
from bench import roofline


def bound(shapes, dtypes, inputs):
    by = roofline.epilogue_bytes(shapes, dtypes, out_only=(), written=(), scalars=12)
    return by, 0.0, "float32"
