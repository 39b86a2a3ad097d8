"""Serving: micro-batching queue, bucketed predict engine, server loop."""
