"""SAM's w_hat = w + s g into its out buffer (argument 5). Bytes only, no
operations counted: every argument read once but those only written, the
buffers it writes written once."""
from bench import roofline


def bound(shapes, dtypes, inputs):
    by = roofline.epilogue_bytes(shapes, dtypes, out_only=(5,), written=(5,), scalars=0)
    return by, 0.0, "float32"
