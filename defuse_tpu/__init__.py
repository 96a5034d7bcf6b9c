"""A gene-fusion discovery engine with the capabilities of deFuse.

Discordant paired-end clustering via a fragment-length EM mixture model,
greedy set-cover fragment assignment, split-read DP breakpoint discovery,
empirical p-values, heuristic filters, annotation and adaboost
classification.  Native C++ runs the sequential host stages; batched JAX
code screens split-read candidates on an NVIDIA GPU.
"""

__version__ = "0.1.0"
