"""Grids (``topology``: the process grid of a training world and the
serving grid) and the current grid with its partition specs
(``sharding``), the counterparts of the JAX package's ``parallel``."""
