"""Distribution layer: sharding rules for params, optimizer state, caches."""
