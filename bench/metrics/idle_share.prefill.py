"""The device's idle share of the traced prefill batches: 1 - (the union of
its operations' intervals) / (the traced window), in %."""
from bench import readers


def read(run):
    return readers.idle_share(run)
