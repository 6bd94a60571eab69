"""The port's multi-device runtime (socp_tpu_torch/parallel/runtime.py,
mesh.py, collectives.py) on gloo ranks on the CPU, in place of the
reference's 8 faked XLA devices (tests/conftest.py:21-25).

Each multi-rank test spawns its ranks through tests/_dist_ranks.py: every
rank joins with a timeout on its collectives, the run has a deadline, and
the first rank to fail or the deadline kills every rank and fails the
test, so none of these tests can wait past its own limit.

Tolerances: on two ranks every reduction here is one addition (or a
comparison) of the two ranks' values, so the port is held bit for bit to
the local sum, to the reference's `ring_allreduce` and `lax.psum` on a
faked mesh of two devices, and each rank to the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec

from socp_tpu.parallel.collectives import ring_allreduce as ref_ring
from socp_tpu_torch.parallel import collectives as coll
from socp_tpu_torch.parallel.mesh import batch_mesh
from socp_tpu_torch.parallel.runtime import init_distributed
from tests import _dist_ranks
from tests._host_memory import release_host_memory  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """On these shapes the port's CPU path is eager-op overhead, and
    torch's intra-op threads only contend with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# x[r] is rank r's tensor; the rings reduce its first p columns in the
# given chunks: 12 in 3 is equal, 6 in 4 and 12 in 5 are numpy's
# array_split sizes (2, 2, 1, 1 and 3, 3, 2, 2, 2)
X_SHAPE = (2, 4, 12)
RINGS = ((12, 1), (12, 3), (6, 4), (12, 5))


def _ref_mesh_sums(x, chunks):
    """The reference's ring_allreduce and lax.psum of x over a faked mesh
    of x.shape[0] devices (tests/test_schur.py:124-146)."""
    ndev = x.shape[0]
    mesh = Mesh(np.asarray(jax.devices()[:ndev]), ("blocks",))

    def body(xl):
        return (ref_ring(xl[0], "blocks", ndev, n_chunks=chunks)[None],
                jax.lax.psum(xl[0], "blocks")[None])

    ring, psum = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=PartitionSpec("blocks"),
        out_specs=(PartitionSpec("blocks"), PartitionSpec("blocks")),
    ))(jnp.asarray(x))
    return np.asarray(ring)[0], np.asarray(psum)[0]


def test_collectives_on_two_ranks():
    x = np.random.default_rng(0).normal(size=X_SHAPE)
    ranks = _dist_ranks.run(2, "collectives", x=x, p_chunks=RINGS)
    for other in ranks[1:]:
        for key, v in ranks[0].items():
            assert np.array_equal(v, other[key]) if isinstance(v, np.ndarray) \
                else v == other[key], key
    out = ranks[0]
    total = x[0] + x[1]
    assert np.array_equal(out["psum"], total)
    assert np.array_equal(out["allsum"], total)
    assert np.array_equal(out["pmin"], np.minimum(x[0], x[1]))
    assert np.array_equal(out["gather"], x)
    assert out["scalar_psum"] == total[0, 0]
    assert out["any_one"] and not out["any_none"]
    for p, chunks in RINGS:
        assert np.array_equal(out[f"ring_{p}_{chunks}"], total[:, :p]), (p, chunks)
    for chunks in (1, 3):
        ring, psum = _ref_mesh_sums(x, chunks)
        assert np.array_equal(out[f"ring_12_{chunks}"], ring)
        assert np.array_equal(out["psum"], psum)
    assert out["counts"] == {"psum": 2, "pmin": 1, "pany": 2, "all_gather": 1,
                             "allsum": 1, "ring_allreduce": len(RINGS),
                             "staged": 0}
    assert out["identity_without_group"]


def test_meshes_on_four_ranks():
    ranks = _dist_ranks.run(4, "meshes", local_world_size=2)
    for r, out in enumerate(ranks):
        assert (out["rank"], out["world"], out["backend"]) == (r, 4, "gloo")
        assert out["batch"] == (("batch",), (4,))
        assert out["blocks"] == (("blocks",), (4,))
        for bad in (3, 8):
            assert "a mesh of" in out[f"batch_mesh({bad})"]
        # one scenario row per node: one node without LOCAL_WORLD_SIZE,
        # two with 2 ranks a node
        assert out["pod_default"] == (("scenario", "blocks"), (1, 4))
        assert out["pod_by_node"] == (2, 2)
        assert out["pod"] == (("scenario", "blocks"), [[0, 1], [2, 3]])
        row, col = divmod(r, 2)
        assert out["row_sum"] == float(4 * row + 1)       # ranks of the row
        assert out["col_sum"] == float(2 + 2 * col)       # ranks of the column
        assert out["shard_all_axes"] == [2 * r, 2 * r + 1]
        assert out["shard_batch"] == [3 * r, 3 * r + 1, 3 * r + 2]
        assert "not divisible" in out["shard_indivisible"]


def test_init_distributed_reads_torchrun_environment():
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": _dist_ranks.free_port()}
    ranks = _dist_ranks.run(2, "env_init", env=env)
    assert ranks == [{"rank": r, "world": 2, "backend": "gloo",
                      "same_after": True} for r in range(2)]


def test_a_rank_stuck_in_a_collective_is_killed_at_the_deadline():
    with pytest.raises(TimeoutError, match="every rank killed"):
        _dist_ranks.run(2, "stuck", timeout=4.0)


def test_single_process_without_environment_is_a_noop(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    init_distributed()
    init_distributed(device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        batch_mesh()


def test_init_errors_propagate_and_nothing_falls_back(tmp_path):
    """No CUDA: asking for the card raises, and NCCL on the CPU build
    raises, without a gloo group taking their place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    store = f"file://{tmp_path}/store"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_distributed(0, 1, store, device="cuda")
    assert not dist.is_initialized()
    if dist.is_nccl_available():
        pytest.skip("this build of torch has NCCL")
    with pytest.raises((RuntimeError, ValueError)):
        init_distributed(0, 1, store, device="cpu", backend="nccl")
    assert not dist.is_initialized()


def test_collectives_without_a_group_are_the_identity():
    coll.reset_counts()
    t = torch.arange(6.0).reshape(2, 3)
    assert coll.psum(t) is t and coll.pmin(t) is t and coll.allsum(t) is t
    assert coll.ring_allreduce(t, None, n_chunks=2) is t
    flag = t[0, 0] > 0
    assert coll.pany(flag) is flag
    assert np.array_equal(coll.all_gather(t).numpy(), t[None].numpy())
    assert set(coll.counts().values()) == {0}
