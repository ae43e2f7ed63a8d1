"""The weight-space kernels' (sq_norm, fused_axpy, fused_dot_norms, the
AdamW or SGD epilogue, sam_perturb) share of their roofline over the traced
training steps, by bytes: the summed bounds of their calls
(`bounds/<operator>.py`) over the device time charged to them, in %."""
from bench import readers

OPS = ("repro_torch::sq_norm", "repro_torch::fused_axpy", "repro_torch::fused_dot_norms",
       "repro_torch::adamw_epilogue", "repro_torch::sgd_epilogue", "repro_torch::sam_perturb")


def read(run):
    return readers.roofline_share(run, "epilogue_roofline.train", OPS)
