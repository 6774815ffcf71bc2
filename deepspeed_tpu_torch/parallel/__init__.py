"""Device grids (``topology``): the serving subset of the JAX package's
``parallel``."""
