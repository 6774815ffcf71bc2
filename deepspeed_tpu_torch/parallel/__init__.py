"""Grids (``topology``: the process grid of a training world and the
serving grid), the current grid with its partition specs (``sharding``),
the model axis's layout (``tensor_parallel``, ``auto_tp``), the expert
axis's (``expert_parallel``) and a rank's view for the model's forward
(``context``), the counterparts of the JAX package's ``parallel``."""
