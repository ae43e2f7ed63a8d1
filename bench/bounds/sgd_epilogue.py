"""The SGD epilogue: w and the momentum (arguments 0 and 2) updated in
place. Bytes only, no operations counted: every argument read once but
those only written, the buffers it writes written once."""
from bench import roofline


def bound(shapes, dtypes, inputs):
    by = roofline.epilogue_bytes(shapes, dtypes, out_only=(), written=(0, 2), scalars=0)
    return by, 0.0, "float32"
