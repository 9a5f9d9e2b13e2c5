"""Serving layer of the port: the batched prefill + greedy decode engine."""
