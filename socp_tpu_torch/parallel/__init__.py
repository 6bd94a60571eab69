"""Block-structured solves (the port of `socp_tpu/parallel/`): so far the
block-Schur KKT of `schur.py` on one device."""
