"""The scale-up domain: sharding rules and the mesh-real memory tiers."""
