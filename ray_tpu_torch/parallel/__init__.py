"""Training steps (one device; the mesh and sharding come later)."""
