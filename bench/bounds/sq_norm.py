"""The weight space's sum of squares of a buffer (one fp32 result). Bytes
only, no operations counted: every argument read once but those only
written, the buffers it writes written once."""
from bench import roofline


def bound(shapes, dtypes, inputs):
    by = roofline.epilogue_bytes(shapes, dtypes, out_only=(), written=(), scalars=4)
    return by, 0.0, "float32"
