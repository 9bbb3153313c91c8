"""A plain-torch reference of GAP's PageRank product on a graph given as an
edge list, for ``test_torch_kron.py``. It imports neither JAX nor either
package of this repository.

``y_i = Σ_{j ∈ N(i)} x_j / deg(j)`` (GAP's pull-direction ``pr.cc``), with
``deg(j)`` counted from the arcs whose source is ``j``, in float64, in
blocks of ``BLOCK`` arcs, with TF32 off.
"""

import numpy as np
import torch

BLOCK = 1 << 16


def product(src: np.ndarray, dst: np.ndarray, n: int,
            x: torch.Tensor) -> torch.Tensor:
    """``P·x`` (float64) for arcs ``src[e] → dst[e]`` (row ``src[e]`` holds
    neighbour ``dst[e]``) and ``x`` of shape (n,) or (n, k)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deg = np.bincount(src, minlength=n).astype(np.float64)
    xd = x.detach().to(torch.float64).cpu()
    y = torch.zeros(xd.shape, dtype=torch.float64)
    for e0 in range(0, src.shape[0], BLOCK):
        s = torch.as_tensor(src[e0: e0 + BLOCK], dtype=torch.int64)
        d = torch.as_tensor(dst[e0: e0 + BLOCK], dtype=torch.int64)
        w = torch.as_tensor(1.0 / deg[dst[e0: e0 + BLOCK]])
        term = xd[d] * (w if xd.ndim == 1 else w[:, None])
        y.index_add_(0, s, term)
    return y
