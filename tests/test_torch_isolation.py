"""The port stands alone: it imports neither jax nor anything of socp_tpu,
and its entry points run on CUDA unless told otherwise."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import socp_tpu_torch
from socp_tpu_torch.carry import from_reference_warm
from socp_tpu_torch.cones.layout import make_layout
from socp_tpu_torch.examples import (admm_stochastic, batched_robust_ls,
                                     block_schur, huge_cone, warm_start)
from socp_tpu_torch.examples import portfolio as ex_portfolio
from socp_tpu_torch.models.portfolio import portfolio
from socp_tpu_torch.models.robust_ls import robust_ls_batch
from socp_tpu_torch.models.stochastic import scenario_portfolio
from socp_tpu_torch.parallel.admm import admm_consensus
from socp_tpu_torch.parallel.dryrun import entry
from socp_tpu_torch.parallel.hugecone import prepare_huge, solve_huge
from socp_tpu_torch.parallel.schur import random_block_problem, solve_block
from tests._host_memory import release_host_memory  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def test_imports_without_jax_and_without_the_reference():
    """In a fresh interpreter (this one has jax loaded by conftest) with
    jax blocked, every module of the port imports and no socp_tpu module
    gets loaded."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import socp_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            socp_tpu_torch.__path__, "socp_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        loaded = [m for m in sys.modules
                  if m == "socp_tpu" or m.startswith("socp_tpu.")]
        assert not loaded, loaded
        assert "triton" not in sys.modules
        print(" ".join(names))
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = res.stdout.split()
    assert len(names) >= 28, names
    for new in ("models.random_socp", "models.portfolio", "carry", "api",
                "parallel.schur", "parallel.admm", "models.stochastic",
                "utils.checkpoint", "parallel.hugecone", "parallel.mesh",
                "parallel.runtime", "parallel.collectives", "parallel.batch",
                "parallel.dryrun", "utils.oracle", "utils.metrics",
                "utils.profiling", "examples", "examples.portfolio",
                "examples.batched_robust_ls", "examples.warm_start",
                "examples.block_schur", "examples.admm_stochastic",
                "examples.huge_cone"):
        assert f"socp_tpu_torch.{new}" in names


def test_rank_helper_imports_no_jax():
    """tests/_dist_ranks.py is what a spawned rank imports to find its
    target: with jax blocked it imports, and loads nothing of socp_tpu."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        from tests import _dist_ranks
        loaded = [m for m in sys.modules
                  if m == "socp_tpu" or m.startswith("socp_tpu.")]
        assert not loaded, loaded
        print(" ".join(sorted(_dist_ranks.CASES)))
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert {"collectives", "schur", "admm", "hugecone"} <= set(res.stdout.split())


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    c, G, h, dims = robust_ls_batch(0, 2, n=4, k=6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        socp_tpu_torch.solve_batch_raw(c, G, h, dims)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        socp_tpu_torch.prepare_batch(c, G, h, dims)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        socp_tpu_torch.solve(portfolio(0, n=6, k=2)[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_block(random_block_problem(0, K=2, nb=6, p=3)[0])
    c5, G5, h5, dims5, A5, b5, info = scenario_portfolio(0, n=4, k=2,
                                                         n_scenarios=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        admm_consensus(c5, G5, h5, dims5, info["n"], A=A5, b=b5, outer_iters=1)
    G = np.vstack([np.eye(3), -np.eye(3)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_huge(np.ones(3), G, np.ones(6), 2, (4,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_huge(np.ones(3), G, np.ones(6), 2, (4,))
    layout = make_layout(dims)
    x, s = np.zeros((2, 6)), np.zeros((2, layout.m_pad))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_reference_warm(x, np.zeros((2, 0)), s, s, layout)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    for run in (lambda: ex_portfolio.run(n=6, k=2),
                lambda: batched_robust_ls.run(B=2, n=4),
                lambda: warm_start.run(n=6, k=2, days=1),
                lambda: block_schur.run(K=2),
                lambda: admm_stochastic.run(S=2, n=4, rounds=1),
                lambda: huge_cone.run(n=4, q=9, l=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
