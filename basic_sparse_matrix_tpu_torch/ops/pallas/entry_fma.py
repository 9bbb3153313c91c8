"""Per-entry fused multiply-add into an output tile: the K6 CUDA kernel and
its plain version.

Counterpart of the kernel in ``benchmarks/entry_fma_probe.py`` (``build``),
the cost probe of the streaming SpMM's inner step. :func:`entry_fma`
computes ``C = 0; for e: C[ii[e], :] += vv[e] * B[kk[e], :]`` with ``B`` and
``C`` of shape (rows, lanes), entries that name one output row summed:

* on CUDA tensors with one of the two hand-written kernels of
  ``csrc/entry_fma.cu``, or it raises:

  - ``"atomic"``: C in global memory (L2 at the probe's sizes), one thread
    per entry and four lanes, ``atomicAdd`` into L2 after a memset. Every
    tile takes it unless the caller asks otherwise;
  - ``"cluster"``, on request, for tiles that fit a thread-block cluster's
    shared memory (:func:`cluster_geometry`): the lanes cut into slices, one
    cluster of 16 blocks (8 where the card cannot hold 16) per slice, each
    block holding its rows of the slice in shared memory; adds go to the
    owning block through distributed shared memory; one launch, no memset,
    no global atomics, C written once. On the H100 it loses to the atomic
    kernel at every shape measured (see ``DEFAULT_KERNEL``);

* on CPU tensors with :func:`entry_fma_reference`, an ``index_add_``.

Both kernels add in no fixed order, so their float32 sums differ from the
plain version's in the last bits. ``LAUNCHES`` counts kernel launches,
``LAUNCHES_BY_KERNEL`` the same per kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

# Launches of the K6 CUDA kernel in this process (a plain counter that a
# caller may reset to 0).
LAUNCHES = 0
LAUNCHES_BY_KERNEL = {"cluster": 0, "atomic": 0}

# Blocks of a cluster: Hopper's largest (non-portable) size, and the
# portable size taken where the card cannot hold that.
CLUSTER_SIZES = (16, 8)
# Thread blocks the lane slices aim to put on the card at once: 8 clusters
# of 16 (or 16 of 8) on the H100's 132 SMs.
CLUSTER_BLOCKS = 128
# Every cluster reads all entries, so a tile that needs more lane slices
# than this keeps the atomic kernel.
MAX_CLUSTERS = 32
# Largest dynamic shared memory one thread block can have on Hopper.
SMEM_MAX_BYTES = 232448


@dataclasses.dataclass(frozen=True)
class ClusterGeometry:
    """How the cluster kernel cuts a (rows, lanes) tile."""

    cluster_size: int     # blocks of a cluster
    rows_per_block: int   # rows of the tile one block holds
    lane_slice: int       # lanes one cluster owns
    n_clusters: int       # lane slices

    @property
    def smem_bytes(self) -> int:
        return self.rows_per_block * self.lane_slice * 4


def cluster_geometry(rows: int, lanes: int,
                     cluster_size: int = CLUSTER_SIZES[0]
                     ) -> Optional[ClusterGeometry]:
    """The cluster kernel's cut of a (rows, lanes) float32 tile, or ``None``
    where the tile does not fit and the atomic kernel is taken. Each block
    of a cluster holds ``ceil(rows / cluster_size)`` rows; the lane slice is
    ``lanes`` over the clusters that run side by side (``CLUSTER_BLOCKS /
    cluster_size``), halved until a block's share fits its shared memory;
    more than ``MAX_CLUSTERS`` slices means it does not fit."""
    if rows < 1 or lanes < 1:
        return None
    rpb = -(-rows // cluster_size)
    ls = -(-lanes // max(CLUSTER_BLOCKS // cluster_size, 1))
    while rpb * ls * 4 > SMEM_MAX_BYTES and ls > 1:
        ls = -(-ls // 2)
    n_clusters = -(-lanes // ls)
    if rpb * ls * 4 > SMEM_MAX_BYTES or n_clusters > MAX_CLUSTERS:
        return None
    return ClusterGeometry(cluster_size, rpb, ls, n_clusters)


@functools.lru_cache(maxsize=None)
def _resident_clusters(cluster_size: int, smem_bytes: int,
                       device_index: int) -> int:
    """Clusters of this size and shared memory the card holds at once (the
    occupancy query of the built kernel; 0: none can be resident)."""
    from ...runtime import cuda_kernels

    lib = cuda_kernels.load()
    with torch.cuda.device(device_index):
        n = lib.bsm_entry_fma_cluster_fit(cluster_size, smem_bytes)
    if n < 0:
        cuda_kernels.check_launch(lib, -n, "entry_fma cluster occupancy")
    return n


@functools.lru_cache(maxsize=None)
def pick_cluster_geometry(rows: int, lanes: int,
                          index: int) -> Optional[ClusterGeometry]:
    """:func:`cluster_geometry` at the largest cluster size of
    ``CLUSTER_SIZES`` that CUDA device ``index`` can hold; ``None`` where
    the tile does not fit (the atomic kernel). A tile that fits by size but
    whose cluster the card refuses at every size raises."""
    refused = []
    for cs in CLUSTER_SIZES:
        geo = cluster_geometry(rows, lanes, cs)
        if geo is None:
            continue
        if _resident_clusters(cs, geo.smem_bytes, index) > 0:
            return geo
        refused.append(geo)
    if refused:
        raise RuntimeError(f"entry_fma: the card can hold no cluster of "
                           f"{refused}")
    return None


# The kernel entry_fma launches when the caller names none, whatever the
# tile's size. The cluster kernel was built for the tiles that fit a
# cluster's shared memory and measured on the H100 beside the atomic kernel
# (probes/entry_fma_probe.py, device time): 4096 x 128 with 8192 entries
# 25.6 against 9.1 us, 4096 x 512 74.2 against 15.0 us, every entry in one
# row 3181 against 45.3 us. A scalar add into another block's shared memory
# costs far more than a float4 atomic in L2, and adds into one address queue
# at about 0.4 us each. So no size takes it by default; kernel="cluster"
# runs it.
DEFAULT_KERNEL = "atomic"


def _check(ii, kk, vv, b, rows: int, check_range: bool = True) -> None:
    if ii.ndim != 1 or ii.shape != kk.shape or ii.shape != vv.shape \
            or b.ndim != 2 or b.shape[0] != rows:
        raise ValueError(f"entry_fma takes ii, kk, vv (E,) and b (rows, "
                         f"lanes) with rows = {rows}, got "
                         f"{tuple(ii.shape)}, {tuple(kk.shape)}, "
                         f"{tuple(vv.shape)}, {tuple(b.shape)}")
    if ii.dtype != torch.int32 or kk.dtype != torch.int32 \
            or vv.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"entry_fma takes int32 ii and kk and float32 vv "
                        f"and b, got {ii.dtype}, {kk.dtype}, {vv.dtype}, "
                        f"{b.dtype}")
    if not (ii.device == kk.device == vv.device == b.device):
        raise ValueError("ii, kk, vv and b must share one device")
    if check_range and ii.numel():
        lo, hi = torch.aminmax(torch.stack([ii, kk]))
        if int(lo) < 0 or int(hi) >= rows:
            raise IndexError(f"entry_fma indices outside [0, {rows})")


def entry_fma_reference(ii: torch.Tensor, kk: torch.Tensor,
                        vv: torch.Tensor, b: torch.Tensor,
                        rows: int) -> torch.Tensor:
    """Plain PyTorch version of K6: every entry's product ``v * B[k]``
    added into row ``i`` with ``index_add_``. Returns (rows, lanes)
    float32."""
    _check(ii, kk, vv, b, rows)
    out = torch.zeros((rows, b.shape[1]), dtype=torch.float32,
                      device=b.device)
    return out.index_add_(0, ii, vv[:, None] * b.index_select(0, kk))


def entry_fma(ii: torch.Tensor, kk: torch.Tensor, vv: torch.Tensor,
              b: torch.Tensor, rows: int, *,
              check_range: bool = True,
              kernel: Optional[str] = None) -> torch.Tensor:
    """``C[ii[e], :] += vv[e] * b[kk[e], :]`` over all entries into a zero
    (rows, lanes) float32 tile: a K6 CUDA kernel for CUDA tensors, the
    plain version for CPU ones.

    Args:
      ii, kk: (E,) int32 output and source row of each entry, in
        ``[0, rows)`` (checked on the host; one small device read).
      vv: (E,) float32 value of each entry.
      b: (rows, lanes) float32, contiguous.
      rows: the tile's height.
      check_range: False skips the range check of ``ii`` and ``kk`` (two
        device reads that wait for the stream). Only for a caller that has
        already made this call once with the same indices, such as a
        timing loop: the kernels themselves do no bounds checks.
      kernel: ``None`` takes ``DEFAULT_KERNEL`` (the atomic kernel, for
        every tile); ``"cluster"`` or ``"atomic"`` asks for one of them, and the
        cluster kernel raises on a tile that does not fit a cluster's shared
        memory (:func:`cluster_geometry`: 4096 x 128 and 4096 x 512 fit,
        10^6 x 512 does not). No kernel steps down to the other.
    """
    if not b.is_cuda:
        return entry_fma_reference(ii, kk, vv, b, rows)
    global LAUNCHES
    from ...runtime import cuda_kernels

    _check(ii, kk, vv, b, rows, check_range)
    for name, t in (("ii", ii), ("kk", kk), ("vv", vv), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"entry_fma: {name} must be contiguous")
    if kernel not in (None, "cluster", "atomic"):
        raise ValueError(f"kernel must be 'cluster', 'atomic' or None, got "
                         f"{kernel!r}")
    lanes = int(b.shape[1])
    geo = None
    if (kernel or DEFAULT_KERNEL) == "cluster":
        index = b.device.index
        geo = pick_cluster_geometry(
            rows, lanes,
            torch.cuda.current_device() if index is None else index)
        if geo is None:
            raise ValueError(f"entry_fma: a ({rows}, {lanes}) tile does not "
                             f"fit a cluster's shared memory")
    out = torch.empty((rows, lanes), dtype=torch.float32, device=b.device)
    lib = cuda_kernels.load()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        args = (ii.data_ptr(), kk.data_ptr(), vv.data_ptr(), b.data_ptr(),
                out.data_ptr(), int(ii.shape[0]), rows, lanes)
        if geo is not None:
            status = lib.bsm_entry_fma_cluster(
                *args, geo.cluster_size, geo.rows_per_block, geo.lane_slice,
                geo.n_clusters, stream)
        else:
            vec = 4 if lanes % 4 == 0 and b.data_ptr() % 16 == 0 \
                and out.data_ptr() % 16 == 0 else 1
            status = lib.bsm_entry_fma(*args, vec, stream)
    name = "atomic" if geo is None else "cluster"
    LAUNCHES += 1
    LAUNCHES_BY_KERNEL[name] += 1
    cuda_kernels.check_launch(lib, status, f"entry_fma ({name} kernel)")
    return out
