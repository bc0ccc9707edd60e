"""The launch layer: production meshes, sharding plans, the dry run and
its sweep and hill-climb drivers."""
