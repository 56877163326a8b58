"""Host utilities of the port: copies of the JAX package's ``utils/``
(but ``jax_setup.py``, whose compilation cache is jax-only; the engine
reads its NaN switch, ``AMRF_DEBUG_NANS``, itself)."""
