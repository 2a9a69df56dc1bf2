"""Serving: the in-memory engine, the paged KV cache and the
continuous-batching decode engine."""
