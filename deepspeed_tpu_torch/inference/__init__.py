"""Serving: the dense v1 engine (``init_inference``), and the paged KV
cache, model runner, v2 engine and scheduler."""
from .engine import InferenceEngine, init_inference  # noqa: F401
