"""Aggregation of the worker-major gradient buffer and the train step."""
