"""Importable toy losses for the ascent-service loopback path (counterpart
of `repro.service.testing`).

The standalone server resolves its loss by import path (``--loss
module:attr``), so losses used by loopback tests live where a server
subprocess can import them. The `w{i}` / `b{i}` MLP here takes the same tree
as the reference's, so a client of either package can drive a server of the
other on it. `jax.nn.gelu` defaults to the tanh approximation, and so does
this one.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: what a loopback client passes as `loss_spec` to reach `mlp_loss` below
MLP_LOSS_SPEC = "repro_torch.service.testing:mlp_loss"


def mlp_init(seed: int = 0, widths=(8, 32, 4), device="cuda") -> dict:
    """{"w{i}": (a, b) normal / sqrt(a), "b{i}": zeros}, drawn with numpy."""
    rng = np.random.default_rng(seed)
    params = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        w = (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
        params[f"w{i}"] = torch.from_numpy(w).to(device)
        params[f"b{i}"] = torch.zeros(b, device=device)
    return params


def mlp_loss(params, batch, gen=None):
    h = batch["x"]
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            h = F.gelu(h, approximate="tanh")
    onehot = F.one_hot(batch["y"].long(), h.shape[-1]).to(h.dtype)
    loss = -torch.mean(torch.sum(F.log_softmax(h, dim=-1) * onehot, dim=-1))
    return loss, {"logits": h}
