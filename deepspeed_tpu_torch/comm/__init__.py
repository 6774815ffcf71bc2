"""Communication helpers of the port: the host-side payload codec of
``qcomm`` (the paged-KV handoff's wire format, and qcomm's wire-byte
accounting) and ``budget``'s collective plans, which the autotuner's
roofline reads."""
