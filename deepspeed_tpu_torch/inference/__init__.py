"""Serving: paged KV cache, model runner, engine and scheduler."""
