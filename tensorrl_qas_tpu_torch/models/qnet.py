"""Q-network: the reference's MLP (``agents/DeepQ.py:147-155``).

Linear layers with LeakyReLU(0.01) and Dropout between them and a linear
head.  Shipped configs use 5 x 1000 hidden units and dropout 0; the
agent evaluates the network in eval mode, as the JAX package always
applies it deterministically.  ``params_from_jax`` carries the JAX
package's Flax ``QNetwork`` parameters over, so both compute the same
Q-values.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import numpy as np
import torch
from torch import nn


class QNetwork(nn.Module):
    """MLP: state vector -> Q-values over the action space."""

    def __init__(self, in_features: int, hidden: Sequence[int],
                 n_actions: int, dropout: float = 0.0,
                 negative_slope: float = 0.01):
        super().__init__()
        widths = [in_features, *hidden]
        self.hidden = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.head = nn.Linear(widths[-1], n_actions)
        self.act = nn.LeakyReLU(negative_slope)
        self.drop = nn.Dropout(dropout) if dropout > 0.0 else nn.Identity()

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax ``Dense`` defaults: LeCun-normal kernels (truncated at two
        standard deviations) and zero biases."""
        for lin in (*self.hidden, self.head):
            std = math.sqrt(1.0 / lin.in_features) / 0.87962566103423978
            w = torch.randn(lin.weight.shape, generator=generator)
            out = w.abs() > 2.0
            while out.any():              # resample outside two stddevs
                w[out] = torch.randn(int(out.sum()), generator=generator)
                out = w.abs() > 2.0
            with torch.no_grad():
                lin.weight.copy_(w * std)
                lin.bias.zero_()

    def forward(self, x):
        for lin in self.hidden:
            x = self.drop(self.act(lin(x)))
        return self.head(x)


def params_from_jax(params) -> dict:
    """Flax ``QNetwork`` params -> this module's ``state_dict``.

    ``params``: the Flax variables (``{'params': {'Dense_i': {'kernel',
    'bias'}}}`` or the inner dict), as numpy arrays; ``Dense_i/kernel`` is
    (in, out), the transpose of ``nn.Linear.weight``.  The last Dense is
    the head.
    """
    p = params.get("params", params)
    names = sorted(p, key=lambda k: int(k.split("_")[-1]))
    out = {}
    for i, name in enumerate(names):
        prefix = "head" if i == len(names) - 1 else f"hidden.{i}"
        kernel = np.asarray(p[name]["kernel"], dtype=np.float32)
        out[f"{prefix}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.T))
        out[f"{prefix}.bias"] = torch.from_numpy(
            np.asarray(p[name]["bias"], dtype=np.float32).copy())
    return out
