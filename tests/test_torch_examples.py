"""The port's examples (``basic_sparse_matrix_tpu_torch/examples``) run on
the CPU at a small size, and what they print says they solved: each
residual under its bound (float32 solves of a well-conditioned Laplacian:
1e-4 relative, the direct solves' backward-error limit), the factorization
named, the spectral bounds inside the Laplacian's (0, 8)."""

import re

import pytest
import torch

from basic_sparse_matrix_tpu_torch.examples import (
    distributed_serving,
    poisson_solve,
    serving,
)

torch.set_num_threads(1)


def _numbers(pattern, text):
    return [float(m) for m in re.findall(pattern, text)]


@pytest.mark.parametrize("k,n_rhs", [(8, 2), (12, 1)])
def test_serving_example(capsys, k, n_rhs):
    serving.main(["--k", str(k), "--n-rhs", str(n_rhs), "--repeats", "3",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"n={k * k}  device=cpu" in out
    assert re.search(r"factorization=\S+", out)
    res = _numbers(r"max residual ([0-9.e+-]+)", out)
    assert len(res) == 3 and max(res) < 1e-4


@pytest.mark.parametrize("shards", [1, 3])
def test_poisson_solve_example(capsys, shards):
    poisson_solve.main(["--k", "8", "--shards", str(shards),
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "device: cpu" in out
    res = _numbers(r"relative residual ([0-9.e+-]+)", out)
    assert len(res) == (4 if shards > 1 else 3) and max(res) < 1e-4
    assert _numbers(r"IC\(0\)-PCG: (\d+) iterations", out)
    assert ("distributed CG x3" in out) == (shards > 1)


@pytest.mark.parametrize("shards", [1, 4])
def test_distributed_serving_example(capsys, shards):
    distributed_serving.main(["--k", "6", "--shards", str(shards),
                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"n=36  shards={shards}  device=cpu" in out
    res = _numbers(r"rel residual ([0-9.e+-]+)", out)
    assert len(res) == 3 and max(res) < 1e-4
    (lo, hi), = re.findall(r"spectral bounds ~\[([0-9.]+), ([0-9.]+)\]",
                           out)
    lo, hi = float(lo), float(hi)
    assert 0.0 < lo < hi < 8.0
