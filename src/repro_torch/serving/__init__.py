"""Serving: paged KV pool + allocator, sampling params, the engine."""
