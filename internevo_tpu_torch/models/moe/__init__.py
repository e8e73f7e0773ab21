"""MoE layers of the port: dropless routing and GShard capacity routing
(expert parallelism comes with the multi-GPU slice)."""
