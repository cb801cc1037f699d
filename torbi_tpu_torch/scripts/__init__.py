"""Micro-benchmark labs of the port's kernels, run on the card:
``kernel_lab`` (variants of the banded forward recursion, and the batch-1
spread kernel) and ``chase_lab`` (the parts of the batch-1 chase step)."""
