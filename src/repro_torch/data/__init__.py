from repro_torch.data.synthetic import TokenTask  # noqa: F401
