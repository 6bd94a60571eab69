"""Decomposed solves (the port of `socp_tpu/parallel/`), on one device:
the block-Schur KKT of `schur.py` (BASELINE config 4) and the consensus
ADMM over scenario subproblems of `admm.py` (BASELINE config 5)."""
