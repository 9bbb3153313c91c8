"""Banded-tier dispatch predicate.

Counterpart of the dispatch part of ``basic_sparse_matrix_tpu/models/
banded.py`` (``block_size_for``, ``banded_block_choice``), with the JAX
package's thresholds, so that the port's ``DirectSolver`` sees the same
tier choice as the reference. The banded and BCR factorizations themselves
are not ported yet (``ROADMAP.md`` queue 1 item 4); the solver raises
``NotImplementedError`` where this predicate picks that tier.
"""

from __future__ import annotations

from ..ops.csr import CSR
from ..ops.reorder import bandwidth


def block_size_for(bw: int, n: int | None = None) -> int:
    """Multiple-of-8 block size covering half-bandwidth ``bw``, floored so
    that a narrow band still takes at most ~128 block steps."""
    nb = max(8, -(-max(bw, 1) // 8) * 8)
    if n is not None:
        target = -(-n // 128)                # block size for ~128 scan steps
        target = -(-target // 8) * 8         # rounded up to the 8-alignment
        nb = max(nb, min(target, 128))
    return nb


def banded_block_choice(a: CSR) -> int | None:
    """The block size of the banded tier for ``a``, or ``None`` when the
    band is too wide, its storage too large, or the block rows too few."""
    from ..utils.config import get_config

    cfg = get_config()
    if cfg.banded_max_block <= 0:
        return None
    nb = block_size_for(bandwidth(a), a.rows)
    if nb > cfg.banded_max_block:
        return None
    if 8 * a.rows * nb > cfg.banded_max_bytes:  # 2 blocks/row · nb² · 4 B
        return None
    if a.rows < nb * cfg.banded_min_steps:
        return None
    return nb
