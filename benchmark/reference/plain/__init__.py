"""A frozen copy of part of the port's plain path (``rivslam_tpu_torch`` at
commit 315ce05, imports rewritten to this package), cut to what the check
runs: a frame's preprocessing and window backend (``frame.py``,
``backend/slam.py``), which the stream check runs in float64 from the
program's state, and the fast path's prepare and registration
(``frontend/apdgicp.py``), which the control runs in the program's place.
Everything runs eagerly on any device; the kernel wrappers take their plain
twins. A later change to the port does not move it. The registration and
the global solve are held by ``reference/gicp.py`` and
``reference/pose_graph.py``, written from the methods, and those two are
the witnesses that ``benchmark/tests/test_bench_witness.py`` holds this
copy against."""
