"""Configuration: the JAX package's ``Config`` fields, ``BSM_*`` env overrides
and ``get_config``/``set_config``, plus the CUDA target's own tile fields and
``device``, the device every constructor and loader builds on when its
caller names none (:func:`default_device`; ``"cuda"`` unless ``BSM_DEVICE``
or :func:`use_device` says otherwise).

The dispatch thresholds (``dense_dispatch_density``,
``dense_dispatch_max_bytes``, ``bsr_min_fill``, ``ell_max_overhead``,
``ell_stream``) keep the JAX package's values so that the port's
``spmm_auto`` ladder picks the same rung as the reference for the same
matrix. They were tuned for another device. On the card they open the
candidates of a float32 product of 64 or more columns, and the card's
kernel choice (``ops/spmm.py::_card_kernel``, its constants measured on the
H100) picks among K1, K2 and K8 by each one's modelled device time.

Matmul precision: ``matmul_precision="highest"`` means float32 products in
full float32. PyTorch may run float32 matmuls in TF32 on the GPU when
``torch.backends.cuda.matmul.allow_tf32`` is True, so :func:`matmul_precision`
sets that flag to False explicitly (and cuDNN's likewise) around each dense
product, and restores the caller's setting afterwards.

The direct solver reads ``ordering``, ``supernodal_relax``,
``supernodal_gather``, ``supernodal_scatter``, the ``banded_*`` fields
(``banded_solver="bcr"`` picks block cyclic reduction, any other value the
block scan) and ``dense_cholesky_max_n`` / ``dense_cholesky_min_density``
(``solve_auto``, ``cholesky_auto``), with the JAX package's meanings;
``supernodal_gather="kernel"`` forces the K3 run reads (the JAX package
maps it to element reads). PCG and Lanczos read ``ell_max_overhead`` for
their ELL view, and ``qr_decomp``/``eigen_values`` the densify budget
``dense_dispatch_max_bytes``.

Fields the port accepts but does not act on, because they select between
formulations of one function that only mattered to XLA on the TPU:
``ell_gather_bf16``, ``ell_stream_unroll``, ``bsr_block_rows``,
``bsr_block_cols``, ``rhs_tile``, and ``supernodal_groups_per_program``
(it bounds the size of XLA programs; PyTorch runs eagerly),
``merge_numeric`` ("chunked" | "planned") and ``spgemm_numeric`` ("planned"
| "chunked" | "rowgather" | "mergetree" | "auto"): the chunked, row-gather
and merge-tree variants group scalar gathers for XLA, and the port runs
the one planned formulation of each (``ops/elementwise.py``,
``ops/spgemm.py``) for every value. The JAX package reads ``solve_dtype``
nowhere.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
from typing import Iterator, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    bsr_block_rows: int = 8
    bsr_block_cols: int = 128
    rhs_tile: int = 128
    # Dispatch thresholds of spmm_auto (the reference's values).
    bsr_min_fill: float = 0.02      # block fill below which BSR is skipped
    dense_dispatch_density: float = 0.005  # densify-SpMM threshold
    dense_dispatch_max_bytes: int = 2 << 30
    ell_max_overhead: float = 4.0   # padded-slots/true-nnz cap for ELL
    ell_gather_bf16: int = 0
    # Cell-binned streaming SpMM kernel for wide-RHS hypersparse operands
    # on the GPU: "on" | "off".
    ell_stream: str = "on"
    ell_stream_unroll: int = 8
    # Streaming kernel tiles on the CUDA target. tile_m rows of the output
    # stay in one thread block's shared memory; 0 picks them from the RHS
    # width (ops.pallas.stream_kernel.pick_tile_m). tile_k bins entries by
    # column range; 0 means one k tile over all columns, which keeps the
    # per-cell padding lowest.
    cuda_stream_tile_m: int = 0
    cuda_stream_tile_k: int = 0
    dense_cholesky_max_n: int = 2048
    dense_cholesky_min_density: float = 0.05
    supernodal_relax: int = 8
    supernodal_groups_per_program: int = 48
    supernodal_gather: str = "auto"
    supernodal_scatter: str = "auto"
    ordering: str = "auto"
    banded_max_block: int = 2048
    banded_max_bytes: int = 1 << 30
    banded_min_steps: int = 4
    banded_solver: str = "bcr"
    merge_numeric: str = "chunked"
    spgemm_numeric: str = "planned"
    # Numerics.
    matmul_precision: str = "highest"
    solve_dtype: str = "float32"
    # Distribution.
    mesh_shape: Optional[Tuple[int, ...]] = None
    # Where constructors and loaders build when the caller names no device
    # (default_device): the card. "cpu" (or BSM_DEVICE=cpu) asks for the
    # CPU; any torch device string ("cuda:1") is taken.
    device: str = "cuda"

    @staticmethod
    def from_env(base: Optional["Config"] = None) -> "Config":
        cfg = base or Config()
        overrides = {}
        for f in dataclasses.fields(Config):
            env = os.environ.get(f"BSM_{f.name.upper()}")
            if env is None:
                continue
            if f.type in ("int", int):
                overrides[f.name] = int(env)
            elif f.type in ("float", float):
                overrides[f.name] = float(env)
            else:
                overrides[f.name] = env
        return dataclasses.replace(cfg, **overrides)

    def add_cli_args(self, parser: argparse.ArgumentParser) -> None:
        for f in dataclasses.fields(Config):
            default = getattr(self, f.name)
            parser.add_argument(
                f"--{f.name.replace('_', '-')}", default=default,
                type=type(default) if default is not None else str,
            )

    @staticmethod
    def from_args(args: argparse.Namespace) -> "Config":
        names = {f.name for f in dataclasses.fields(Config)}
        return Config(**{k: v for k, v in vars(args).items() if k in names})


_config = Config.from_env()


def get_config() -> Config:
    return _config


def set_config(cfg: Config) -> None:
    global _config
    _config = cfg


class NoDefaultDevice(RuntimeError):
    """The configured default device is not present on this machine."""


def default_device(device=None):
    """The ``torch.device`` a constructor or loader builds on: ``device``
    when the caller gave one, else the configured ``Config.device`` (the
    card by default). A configured CUDA device on a machine without one
    raises; nothing falls back to the CPU unasked."""
    import torch

    if device is not None:
        return torch.device(device)
    dev = torch.device(get_config().device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDefaultDevice(
            f"the default device is {get_config().device!r} and "
            f"torch.cuda.is_available() is False; to run on the CPU pass "
            f"device=\"cpu\" or set BSM_DEVICE=cpu (or "
            f"utils.config.use_device(\"cpu\"))")
    return dev


@contextlib.contextmanager
def use_device(device: str) -> Iterator[None]:
    """Make ``device`` the default device inside the block (the tests ask
    for ``"cpu"`` this way); the previous configuration returns on exit."""
    prev = get_config()
    set_config(dataclasses.replace(prev, device=str(device)))
    try:
        yield
    finally:
        set_config(prev)


@contextlib.contextmanager
def matmul_precision() -> Iterator[None]:
    """Run the enclosed float32 matmuls at the configured precision:
    "highest" turns TF32 off (``torch.backends.cuda.matmul.allow_tf32 =
    False``, and cuDNN's flag too); any other value allows TF32. The
    caller's flags are restored on exit."""
    import torch

    allow = get_config().matmul_precision.lower() != "highest"
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
