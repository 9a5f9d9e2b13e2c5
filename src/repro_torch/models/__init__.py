"""Dense decoder model of the port: layers, ring KV cache, assembly."""
