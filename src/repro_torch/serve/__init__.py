"""Serving substrate: the dense per-slot KV cache, decode and chunked
prefill steps."""
