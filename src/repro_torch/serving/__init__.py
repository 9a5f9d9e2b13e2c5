"""Serving layer of the port: the batched prefill + greedy decode engine,
and Shabari's cluster simulator (workloads, profiles, baselines, the
experiment runner and the golden scenarios)."""
