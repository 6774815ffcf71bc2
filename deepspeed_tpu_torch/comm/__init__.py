"""Communication of the port: the collectives over ``torch.distributed``
by axis name (``comm``, with the comms logger), the quantized collectives
and the host-side payload codec of ``qcomm`` (the paged-KV handoff's wire
format, and qcomm's wire-byte accounting), the 1-bit compressed
all-reduce (``compressed``), and ``budget``'s collective plans, which the
autotuner's roofline reads."""
