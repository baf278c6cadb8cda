"""The benchmark's own modules: the yardstick that later changes to the
program cannot move.  Nothing here imports JAX or the JAX package, and only
``driver`` imports the program under test (``libde265_tpu_torch``)."""
