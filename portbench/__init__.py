"""The benchmark of ``basic_sparse_matrix_tpu_torch`` on HPCG's operator
(``BENCHMARK.json`` at the repository's root; ``PERF.md``)."""
