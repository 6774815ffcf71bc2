"""deepspeed_tpu_torch — the PyTorch / CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, mirroring its module layout
(``models``, ``ops``, ``inference``) so each module's counterpart is found
by name.  It imports ``torch`` and never ``jax`` or ``deepspeed_tpu``.
Entry points run on a CUDA device unless the caller passes
``device="cpu"``; every Pallas kernel of the ported path is a hand-written
CUDA kernel under ``csrc/`` (see ``ops/kernels``).

Ported so far: the serving path — ``inference.engine_v2.InferenceEngineV2``
(paged KV cache, packed prefill, prefix caching, chunked prefill, batched
decode) and its ``inference.scheduler.ServeScheduler``.
"""
