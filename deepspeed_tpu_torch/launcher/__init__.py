"""The launcher: hostfiles, host filters, multinode runners and the
environment report — counterpart of ``deepspeed_tpu/launcher``."""
