"""Profiling, metrics, and roofline analysis.

Counterpart of ``basic_sparse_matrix_tpu/runtime/profiling.py``: structured
per-op metrics (nnz/s, GFLOP/s, bytes moved), a roofline calculator against
a card's published peaks, timer contexts (CUDA events on the card, the host
clock on the CPU) and ``torch.profiler`` annotations.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import time
from typing import Dict, Iterator, Optional

from ..utils.logging import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Peak numbers of one device, the roofline's denominators. The field
    names are the JAX package's: ``mxu_f32`` is the rate of a product that
    is accurate to float32, ``mxu_bf16`` the matrix units' bf16 rate;
    ``tf32`` (new here) the tensor cores' TF32 rate."""

    name: str
    hbm_bw: float       # bytes/s
    mxu_f32: float      # FLOP/s, float32
    mxu_bf16: float     # FLOP/s
    tf32: float = 0.0   # FLOP/s, 0 where the device has no such mode


# NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 data sheet (dense rates, no
# sparsity, at the full 700 W power limit): HBM3 at 3.35 TB/s; 67 TFLOP/s
# float32 on the CUDA cores; 495 TFLOP/s TF32 and 989 TFLOP/s bf16 on the
# tensor cores.
H100 = ChipSpec(name="nvidia-h100-sxm", hbm_bw=3.35e12, mxu_f32=67e12,
                mxu_bf16=989e12, tf32=495e12)
# Placeholder figures for runs without a GPU (the tests): not a measurement
# of any host.
CPU = ChipSpec(name="cpu", hbm_bw=100e9, mxu_f32=1e12, mxu_bf16=2e12)


def detect_chip(device=None) -> ChipSpec:
    """The spec of ``device`` (default: the current CUDA device when there
    is one, else the CPU), read from ``torch.cuda.get_device_properties``.
    A card without an entry here raises: pass a :class:`ChipSpec` of its
    own to :meth:`OpMetrics.roofline_fraction` instead."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return CPU
    name = torch.cuda.get_device_properties(device).name
    if "H100" in name:
        return H100
    raise ValueError(f"no peak numbers recorded for {name!r}; pass a "
                     f"ChipSpec")


@dataclasses.dataclass
class OpMetrics:
    op: str
    seconds: float
    flops: float = 0.0
    bytes_moved: float = 0.0
    nnz: int = 0

    @property
    def gflops_per_s(self) -> float:
        return self.flops / self.seconds / 1e9 if self.seconds else 0.0

    @property
    def nnz_per_s(self) -> float:
        return self.nnz / self.seconds if self.seconds else 0.0

    def roofline_fraction(self, chip: Optional[ChipSpec] = None) -> float:
        """Achieved fraction of the bound = t_bound / t_measured with
        t_bound = max(memory time, float32 compute time)."""
        chip = chip or detect_chip()
        t_mem = self.bytes_moved / chip.hbm_bw
        t_flop = self.flops / chip.mxu_f32
        t_bound = max(t_mem, t_flop)
        return t_bound / self.seconds if self.seconds else 0.0

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["gflops_per_s"] = self.gflops_per_s
        d["nnz_per_s"] = self.nnz_per_s
        d["roofline_fraction"] = self.roofline_fraction()
        return json.dumps(d)


_registry: Dict[str, OpMetrics] = {}


def record(m: OpMetrics) -> OpMetrics:
    _registry[m.op] = m
    logger.info("metrics %s", m.to_json())
    return m


def all_metrics() -> Dict[str, OpMetrics]:
    return dict(_registry)


@contextlib.contextmanager
def timed(op: str, *, flops: float = 0.0, bytes_moved: float = 0.0,
          nnz: int = 0, device=None) -> Iterator[OpMetrics]:
    """Timer context that records an :class:`OpMetrics`. On a CUDA
    ``device`` (default: the current one when there is one) the time is the
    device's, between two CUDA events on the current stream
    (``runtime.timing.CudaTimer``; the exit waits for the work). On the
    CPU it is the host clock."""
    import torch

    from .timing import CudaTimer

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    m = OpMetrics(op=op, seconds=0.0, flops=flops, bytes_moved=bytes_moved,
                  nnz=nnz)
    if device.type == "cuda":
        timer = CudaTimer(device)
        try:
            with timer:
                yield m
        finally:
            m.seconds = timer.ms / 1e3
            record(m)
        return
    t0 = time.perf_counter()
    try:
        yield m
    finally:
        m.seconds = time.perf_counter() - t0
        record(m)


@contextlib.contextmanager
def trace(name: str):
    """A named range in ``torch.profiler`` traces."""
    import torch

    with torch.profiler.record_function(name):
        yield


def spmm_cost(nnz: int, n_rhs: int, rows: int, cols: int,
              dtype_bytes: int = 4) -> Dict[str, float]:
    """Roofline cost model for gather-style SpMM: every stored entry reads
    one RHS row and the output is written once."""
    flops = 2.0 * nnz * n_rhs
    bytes_moved = (
        nnz * (dtype_bytes + 4)               # values + col indices
        + min(nnz, cols) * n_rhs * dtype_bytes  # RHS rows touched (≥ once)
        + rows * n_rhs * dtype_bytes          # output
    )
    return {"flops": flops, "bytes_moved": bytes_moved}
