"""The flash attention forward: q, k and v read once (k and v only for the
keys some query sees), the output written once; 2 (hd + hd_v) operations a
visible (query, key) pair and head, at the peak of q's dtype."""
from bench import roofline


def bound(shapes, dtypes, inputs):
    causal, window, q_offset = True, 0, 0
    if len(inputs) >= 6 and inputs[3] is not None:
        causal, window, q_offset = bool(inputs[3]), int(inputs[4] or 0), int(inputs[5] or 0)
    by, ops = roofline.flash_bound(shapes[0], shapes[1], shapes[2], dtypes[0], causal, window,
                                   q_offset)
    return by, ops, roofline.DTYPE_NAMES[dtypes[0]]
