"""Scripts run on the card: the micro-benchmark labs of the port's kernels,
``kernel_lab`` (variants of the banded forward recursion, and the batch-1
spread kernel) and ``chase_lab`` (the parts of the batch-1 chase step);
``dense_timing`` (K2's plans, K1 beside it); ``eval_synth`` (the
evaluation harness on synthetic corpora) and ``soak`` (every route
against the oracle)."""
