"""The prefill batches' share of the card's bf16 tensor-core peak: the
forward FLOPs of the traced batches' prompts (`flops.prefill_flops`) over
(the traced window x 989 TFLOP/s), in %."""
from bench import readers


def read(run):
    return readers.mfu(run)
