"""MoE layers of the port (dropless routing; GShard and expert parallelism
come with later slices)."""
