"""The program's optimizers as the training cells build them, one module a
traffic optimizer name, with the check's reading of their state."""
