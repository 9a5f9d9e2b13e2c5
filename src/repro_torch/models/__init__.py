"""Models of the port: layers, ring KV cache, the SSM and MoE blocks, assembly."""
