"""Port of ``repro/dist``: the reference's work partitioning for its
sharded reuse engines (the mesh and sharding rules wait for the model
zoo's training path, ROADMAP queue A)."""
