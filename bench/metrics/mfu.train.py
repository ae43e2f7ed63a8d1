"""The training steps' share of the card's bf16 tensor-core peak: the model
FLOPs of the traced steps (`flops.train_step_flops`: the descent and, for
AsyncSAM, the ascent pass; no recompute) over (the traced window x
989 TFLOP/s), in %."""
from bench import readers


def read(run):
    return readers.mfu(run)
