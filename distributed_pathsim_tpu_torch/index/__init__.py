"""Row grouping for the batch tier (index/mips.py). The ANN index
lanes of the JAX package's ``index/`` are not ported yet."""
