"""Utilities — counterpart of ``deepspeed_tpu/utils`` (memory reporting)."""
