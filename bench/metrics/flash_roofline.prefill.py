"""The flash attention forward kernel's share of its roofline over the
traced prefill batches: the summed bounds of its calls
(`bounds/flash_attention_fwd.py`) over the device time charged to them,
in %."""
from bench import readers

OPS = ("repro_torch::flash_attention_fwd",)


def read(run):
    return readers.roofline_share(run, "flash_roofline.prefill", OPS)
