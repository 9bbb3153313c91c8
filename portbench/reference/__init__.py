"""The plain reference: the same operations as the program, in plain PyTorch,
worked out again from the benchmark's inputs and the configuration alone.

It imports nothing of the program and takes nothing the program made: the
operator is applied as the stencil the configuration states (never through
the program's CSR), the direct solve factors its own dense matrix, and
IC(0)-PCG builds its own incomplete factor on the grid. Every function takes
a :class:`~portbench.reference.precision.Precision`: ``FLOAT64`` is the
reference; ``TF32`` is the control, the same arithmetic with every operand
of a product rounded to TF32 and float32 sums, which a sound comparison
has to fail.
"""
