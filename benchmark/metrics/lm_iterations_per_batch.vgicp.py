"""Outer LM iterations a batch: the program tracer's ``lm_iterations``
(``apdgicp.solve_lm``, one a batch's outer iteration, until its slowest
pair converges) over the window's batches."""


def read(run):
    if not run.get("batches") or not run.get("lm_iterations"):
        return None
    return run["lm_iterations"] / run["batches"]
