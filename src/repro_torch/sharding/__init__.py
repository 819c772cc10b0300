"""Parameter-sharding rules and the per-layer weight gather of the mesh
trainer."""
