"""Serving substrate: dense and paged KV caches, the page allocator and
prefix cache, decode and chunked prefill steps, and the continuous-batching
engine."""
