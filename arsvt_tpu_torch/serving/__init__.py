"""Serving: the HTTP classify server and its micro-batcher."""
