"""The LSTM of model.temporal_mode="lstm" (counterpart of the JAX
package's ``nn.RNN(nn.OptimizedLSTMCell(...))`` in ``models/fusion.py``).

The cell is written out rather than taken from ``nn.LSTM`` so that its
parameters and dtypes are flax's:

- Parameters keep flax's names: ``i{i,f,g,o}`` map the input to each gate
  (no bias), ``h{i,f,g,o}`` the hidden state (with bias), each an
  ``nn.Linear``; ``utils/convert.py`` carries them across like any dense
  layer. They stay f32.
- The carry ``(c, h)`` starts as f32 zeros. Each step casts the inputs,
  ``h`` and the kernels to the compute dtype and computes both products
  and the gates in it; ``c' = f*c + i*g`` and ``h' = o*tanh(c')`` promote
  to f32. So the output is f32 also in bf16.

The sequence is T = model.temporal_frames short, so the products stay
``torch.matmul`` (the JAX package leaves them to XLA, outside any Pallas
kernel).
"""

from __future__ import annotations

import torch
from torch import nn

GATES = ("i", "f", "g", "o")
INPUT_KERNELS = tuple(f"i{g}" for g in GATES)
RECURRENT_KERNELS = tuple(f"h{g}" for g in GATES)


class LSTM(nn.Module):
    """flax ``OptimizedLSTMCell(features)`` run over the time axis by
    ``nn.RNN`` from a zero carry: (B, T, in_features) -> the last step's
    output (B, features), f32."""

    def __init__(self, in_features: int, features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = features
        self.compute_dtype = compute_dtype
        for name in INPUT_KERNELS:
            self.add_module(name, nn.Linear(in_features, features, bias=False))
        for name in RECURRENT_KERNELS:
            self.add_module(name, nn.Linear(features, features))

    def _kernels(self, names, with_bias: bool):
        dt = self.compute_dtype
        mods = [getattr(self, n) for n in names]
        w = torch.cat([m.weight for m in mods]).to(dt)        # (4H, in)
        b = torch.cat([m.bias for m in mods]).to(dt) if with_bias else None
        return w, b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        k_in, _ = self._kernels(INPUT_KERNELS, False)
        k_h, b_h = self._kernels(RECURRENT_KERNELS, True)
        b, t, _ = x.shape
        h = x.new_zeros((b, self.features), dtype=torch.float32)
        c = torch.zeros_like(h)
        # the input's products of every step at once: each row is the same
        # dot product as the step's own
        x_in = torch.matmul(x.to(dt), k_in.t())               # (B, T, 4H)
        for s in range(t):
            gates = (torch.matmul(h.to(dt), k_h.t()) + b_h) + x_in[:, s]
            i, f, g, o = torch.split(gates, self.features, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            g = torch.tanh(g)
            c = f * c + i * g              # f32: c is f32
            h = o * torch.tanh(c)
        return h
