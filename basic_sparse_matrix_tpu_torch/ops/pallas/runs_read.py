"""Contiguous-run reads of the supernodal factor values: the K3 CUDA kernel
and its plain version.

Counterpart of ``basic_sparse_matrix_tpu/ops/pallas/runs_read.py``. The
supernodal numeric phase reads every operand as ``base + rank`` storage
runs; :func:`runs_read` returns ``out[c, :] = lvals[stf[c] : stf[c] +
l_pad]`` for every slot with ``stf[c] >= 0``, and with a leading batch
axis on ``lvals`` (one pattern, ``Bt`` sets of values) ``out[b, c, :] =
lvals[b, stf[c] : stf[c] + l_pad]`` for every system in one launch:

* on a CUDA tensor with the hand-written kernel ``csrc/runs_read.cu`` (one
  warp per run), or it raises;
* on a CPU tensor with :func:`runs_read_reference`, an index gather.

Dead slots (``stf[c] < 0``) and elements past the end of a system's
``lvals`` read as 0 in both (the TPU kernel leaves dead rows unwritten; callers mask them).
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

# Launches of the K3 CUDA kernel in this process (a plain counter that a
# caller may reset to 0).
LAUNCHES = 0


def _check(lvals: torch.Tensor, stf: torch.Tensor, l_pad: int) -> None:
    if lvals.ndim not in (1, 2) or stf.ndim != 1:
        raise ValueError(f"runs_read takes lvals (N,) or (Bt, N) and stf "
                         f"(CRQ,), got {tuple(lvals.shape)} and "
                         f"{tuple(stf.shape)}")
    if lvals.dtype != torch.float32 or stf.dtype != torch.int32:
        raise TypeError(f"runs_read takes float32 lvals and int32 starts, "
                        f"got {lvals.dtype} and {stf.dtype}")
    if lvals.device != stf.device:
        raise ValueError(f"lvals on {lvals.device}, starts on {stf.device}")
    if l_pad < 1:
        raise ValueError(f"run length must be positive, got {l_pad}")


def runs_read_reference(lvals: torch.Tensor, stf: torch.Tensor,
                        l_pad: int) -> torch.Tensor:
    """Plain PyTorch version of K3: one index gather, masked to the live
    slots and to the length of ``lvals``. Returns (CRQ, l_pad), or (Bt, CRQ,
    l_pad) for a batch, float32."""
    _check(lvals, stf, l_pad)
    n = lvals.shape[-1]
    idx = stf.long()[:, None] + torch.arange(l_pad, device=lvals.device)
    live = (stf[:, None] >= 0) & (idx < n)
    out = lvals[..., idx.clamp(0, max(n - 1, 0))] if n else torch.zeros(
        lvals.shape[:-1] + idx.shape, dtype=lvals.dtype, device=lvals.device)
    return torch.where(live, out, torch.zeros((), dtype=lvals.dtype,
                                              device=lvals.device))


def runs_read(lvals: torch.Tensor, stf: torch.Tensor,
              l_pad: int) -> torch.Tensor:
    """Read ``stf.shape[0]`` contiguous runs of ``l_pad`` elements each:
    the K3 kernel for CUDA tensors, the plain version for CPU ones.

    Args:
      lvals: (N,) float32 factor values, or (Bt, N): ``Bt`` systems of one
        pattern, each read at the same starts (one launch for the batch).
      stf: (CRQ,) int32 run starts into a system's ``lvals``; < 0 marks a
        dead slot.
      l_pad: run length.

    Returns (CRQ, l_pad), or (Bt, CRQ, l_pad), float32.
    """
    _check(lvals, stf, l_pad)
    if not lvals.is_cuda:
        return runs_read_reference(lvals, stf, l_pad)
    global LAUNCHES
    from ...runtime import cuda_kernels

    lvals = lvals.contiguous()
    stf = stf.contiguous()
    bt = lvals.shape[0] if lvals.ndim == 2 else 1
    if bt > 65535:
        raise ValueError(f"runs_read takes at most 65535 systems a launch, "
                         f"got {bt}")
    crq = int(stf.shape[0])
    out = torch.empty(lvals.shape[:-1] + (crq, l_pad), dtype=torch.float32,
                      device=lvals.device)
    lib = cuda_kernels.load()
    with torch.cuda.device(lvals.device):
        stream = torch.cuda.current_stream(lvals.device).cuda_stream
        status = lib.bsm_runs_read(lvals.data_ptr(), int(lvals.shape[-1]),
                                   stf.data_ptr(), crq, int(l_pad), bt,
                                   out.data_ptr(), stream)
    LAUNCHES += 1
    cuda_kernels.check_launch(lib, status, "runs_read")
    return out


def win_kernel(lvals: torch.Tensor, starts: torch.Tensor, L: int,
               lpad: int) -> torch.Tensor:
    """Counterpart of ``models/supernodal._win`` through :func:`runs_read`:
    reads each ``starts[u, w]`` run of length ``L`` (read as a run of the
    class length ``lpad >= L``). The TPU version pads the slot count to a
    power of two for its compile cache; the GPU needs no padding, so exactly
    ``u * w`` runs are read. Returns (u, w, L), or (Bt, u, w, L) for a
    batched ``lvals`` (Bt, N)."""
    u, w = starts.shape
    out = runs_read(lvals, starts.reshape(-1).to(torch.int32), lpad)
    return out[..., : u * w, :L].reshape(lvals.shape[:-1] + (u, w, L))
