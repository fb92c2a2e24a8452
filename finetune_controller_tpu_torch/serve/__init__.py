"""Paged continuous-batching serving: page pool, prefix cache, engine, batcher."""
