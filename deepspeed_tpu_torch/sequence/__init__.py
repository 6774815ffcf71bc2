"""Sequence-dimension losses (counterpart of ``deepspeed_tpu/sequence``)."""
