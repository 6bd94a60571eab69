"""Host-side utilities of the port (of `socp_tpu/utils/`): the solver
checkpoint (`checkpoint.py`), the plain-NumPy interior-point oracle that
specifies the solver (`oracle.py`), the benchmark-record schema
(`metrics.py`) and phase timers and torch.profiler traces
(`profiling.py`)."""
