"""PyTorch / CUDA port of the Shabari reproduction.

A package beside ``repro`` (the JAX reference) that runs the serving
slice of the system on an NVIDIA H100: featurize an invocation, size its
vCPU and memory with the online CSOAA agents, execute it on the serving
engine, and feed the observation back. It imports ``torch`` and never
``jax``, and nothing from ``repro``. Entry points take a ``device`` that
defaults to ``"cuda"``; only the CPU tests pass ``"cpu"``.
"""
