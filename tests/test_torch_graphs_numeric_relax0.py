"""The supernodal numeric phase on unrelaxed supernodes (relax 0), called
twice on one schedule with two value sets, against the JAX package's
``factorize_supernodal`` on the ND-ordered 9², 16² and 8³ Laplacians
(``rtol=1e-5``, ``atol=1e-5·max|ref|``). Apart from
``test_torch_graphs_numeric.py`` (relax 8, the batch, the scatter-list
phase, the tag and the card cases) because these cases compile the most
JAX programs: each file stays within about a minute on one worker.
"""

import pytest

from basic_sparse_matrix_tpu_torch.utils import config as pcfg
from test_torch_graphs_numeric import _GRIDS, supernodal_twice_against_jax


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    with pcfg.use_device("cpu"):
        yield


@pytest.fixture
def jax_pkg():
    """The JAX package (the reference)."""
    return pytest.importorskip("basic_sparse_matrix_tpu")


@pytest.mark.parametrize("grid", list(_GRIDS))
def test_unrelaxed_supernodal_refactorization_matches_jax(jax_pkg, grid):
    supernodal_twice_against_jax(jax_pkg, grid, 0)
