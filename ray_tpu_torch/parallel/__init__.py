"""Training steps, device meshes, partition rules and the sharding plan."""
