"""The weight space's y = a x + w into its out buffer (argument 3). Bytes
only, no operations counted: every argument read once but those only
written, the buffers it writes written once."""
from bench import roofline


def bound(shapes, dtypes, inputs):
    by = roofline.epilogue_bytes(shapes, dtypes, out_only=(3,), written=(3,), scalars=0)
    return by, 0.0, "float32"
