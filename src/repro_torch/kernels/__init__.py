"""Hand-written Hopper kernels of the port, one package per TPU kernel, and
``rglru_scan`` for the RG-LRU recurrence, which the JAX package leaves to
XLA (``jax.lax.associative_scan``).

``LAUNCHES`` counts the launches of each kernel by name.  A wrapper adds
one where it launches its kernel on the card, and nowhere else, so a run
can show that its main path went through the kernels.
"""

from collections import Counter

LAUNCHES: Counter = Counter()
