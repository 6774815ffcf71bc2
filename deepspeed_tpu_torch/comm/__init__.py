"""Communication helpers of the port — so far only the host-side payload
codec of ``qcomm`` (the paged-KV handoff's wire format)."""
