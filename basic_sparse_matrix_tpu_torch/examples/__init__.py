"""Runnable examples of the PyTorch port, counterparts of the JAX
package's ``examples/``: ``python -m basic_sparse_matrix_tpu_torch.examples.
<name>`` runs on the card by default and on the CPU with ``--device cpu``."""
