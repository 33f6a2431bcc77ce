"""BatchNorm per-channel statistics as contractions (counterpart of the JAX
package's ``ops/bn_stats.py``, ``model.bn_stats="matmul"``).

The JAX package routes them through its matrix unit as ``dot_general``s:
``ones . x`` for the sum and the diagonal of ``x^T x`` for the sum of
squares, accumulated in f32. Here they are plain torch contractions in f32
(a matrix-vector product, and the per-channel dot product that is the
Gram matrix's diagonal): library calls, as XLA's were, and no kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.ops.fused import channel_rows


def channel_sum_sumsq_matmul(x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x with channels at dim 1 (NCHW or (M, C)) -> per-channel (sum, sum
    of squares), f32."""
    rows = channel_rows(x).float()
    ones = torch.ones(rows.shape[0], dtype=torch.float32, device=rows.device)
    return ones @ rows, torch.einsum("mc,mc->c", rows, rows)
