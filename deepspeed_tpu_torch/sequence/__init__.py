"""Sequence parallelism and sequence-dimension losses (counterpart of
``deepspeed_tpu/sequence``): Ulysses (``layer.py``), ring attention
(``ring.py``) and the chunked cross-entropy (``cross_entropy.py``)."""
from .layer import DistributedAttention, single_all_to_all  # noqa: F401
from .ring import gathered_attention, ring_attention  # noqa: F401
