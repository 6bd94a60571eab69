"""Host-side utilities of the port (of `socp_tpu/utils/`): so far the
solver checkpoint of `checkpoint.py`."""
