"""Decomposed and sharded solves (the port of `socp_tpu/parallel/`): the
block-Schur KKT of `schur.py` (BASELINE config 4), the consensus ADMM
over scenario subproblems of `admm.py` (BASELINE config 5) and the
huge-cone IPM of `hugecone.py` (one SOCP whose cone vector has millions
of rows, in head/tail form with a tall-skinny Gram KKT), on one device
or, with `mesh=`, over the ranks of `torch.distributed`: `runtime.py`
brings the group up (NCCL on the card, gloo on the CPU), `mesh.py` makes
the meshes, `collectives.py` the reductions, `batch.py` shards a
lockstep batch and `dryrun.py` runs one step of each path."""
