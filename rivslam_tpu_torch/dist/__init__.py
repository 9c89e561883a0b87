"""The distributed layer (port of ``rivslam_tpu/dist/``): a process-group
mesh (``mesh``), the data- and model-parallel registration and batched
solves (``dist_gn``) and the edge-sharded pose-graph solve
(``dist_graph``). The submodules are imported by name: the exact
registration imports ``mesh`` for its sums, and ``dist_gn`` imports the
registration."""
