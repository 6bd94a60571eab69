"""The port's CUDA kernels and its card path (needs an NVIDIA GPU).

Marked `cuda`; each test skips, with its reason, where torch sees no CUDA
device, and the decision is taken inside the `card` fixture, never at
import.  On the card:

    python -m pytest -o addopts='' -m cuda tests/test_torch_cuda.py -q

Kernels are held to their plain PyTorch versions bit for bit (the batched
and single-instance kernels in f64 and f32, and the probes); the card path
of the solver is held
to the JAX reference (run on the CPU) as tests/test_torch_solve.py and
tests/test_torch_f32factor.py hold the CPU path.
"""

import numpy as np
import pytest
import torch

import socp_tpu
import socp_tpu_torch
from socp_tpu.models.random_socp import random_socp
from socp_tpu.models.robust_ls import robust_ls_batch
from socp_tpu_torch.ops import chol, probes
# by module name: pytest puts this directory on sys.path, while the
# package name `tests` may resolve to another installation's `tests`
from _host_memory import release_host_memory  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


def _spd(seed, B, n, kappa=1e8, neg=False):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(B, n, n)))
    ev = np.logspace(-np.log10(kappa), 0, n)
    if neg:
        ev[0] = -1e-3
    H = (Q * ev) @ np.swapaxes(Q, 1, 2)
    return 0.5 * (H + np.swapaxes(H, 1, 2))


# (B, n): config 3's shapes, both sides of the micro-tile (4) and panel (32)
# edges, the Cholesky's second schedule (above n = 108), the largest n,
# config 4's blocks (K = 10,240, nb = 10) and a chunk of config 5's
# scenarios (2048, nv = 21)
BATCHED_F64 = [(256, 102), (8, 37), (256, 3), (4, 1), (64, 2), (64, 5),
               (64, 31), (64, 32), (64, 33), (64, 65), (64, 108), (64, 109),
               (16, 169), (4096, 102), (10240, 10), (2048, 21)]


@pytest.mark.parametrize("B,n", BATCHED_F64)
def test_chol_kernel_matches_plain(card, B, n):
    H = torch.as_tensor(_spd(n, B, n), device=card)
    before = chol.chol_launches
    L = chol.chol_batched(H)
    assert chol.chol_launches == before + 1
    assert torch.equal(L, chol.chol_batched_plain(H))


@pytest.mark.parametrize("B,n,k", [(256, 102, 1), (8, 37, 3), (256, 3, 3),
                                   (10240, 10, 8)]
                         + [(B, n, k) for B, n in BATCHED_F64[3:] for k in (1, 3)])
def test_tri_pair_kernel_matches_plain(card, B, n, k):
    """k = 3 at n = 169 is new: one block no longer holds the rhs beside L.
    (10240, 10, 8) is config 4's H^-1 A'."""
    L = chol.chol_batched(torch.as_tensor(_spd(n + k, B, n), device=card))
    rhs = torch.as_tensor(np.random.default_rng(k).standard_normal((B, n, k)),
                          device=card)
    before = chol.tri_pair_launches
    X = chol.tri_pair_batched(L, rhs)
    assert chol.tri_pair_launches == before + 1
    assert torch.equal(X, chol.tri_pair_batched_plain(L, rhs))


def _batched_inputs(dtype, B, n, card, seed=None):
    seed = n if seed is None else seed
    H = _spd(seed, B, n) if dtype == torch.float64 else _spd32(seed, B, n)
    rhs = np.random.default_rng(seed + 1).standard_normal((B, n, 1))
    return (torch.as_tensor(H, dtype=dtype, device=card),
            torch.as_tensor(rhs, dtype=dtype, device=card))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_kernels_back_to_back_calls_give_the_same_bits(card, dtype):
    """Calls queued on one stream with no sync between them."""
    H, rhs = _batched_inputs(dtype, 256, 102, card)
    Ls = [chol.chol_batched(H) for _ in range(3)]
    Xs = [chol.tri_pair_batched(L, rhs) for L in Ls]
    torch.cuda.synchronize()
    for L, X in zip(Ls[1:], Xs[1:]):
        assert torch.equal(L, Ls[0]) and torch.equal(X, Xs[0])
    assert torch.equal(Ls[0], chol.chol_batched_plain(H))
    assert torch.equal(Xs[0], chol.tri_pair_batched_plain(Ls[0], rhs))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_kernels_replay_in_a_cuda_graph(card, dtype):
    """chol_batched then tri_pair_batched at B = 256, n = 102 captured by
    torch.cuda.graph, replayed on the captured inputs and on new ones
    written into them: bit-equal to the plain versions."""
    H, rhs = _batched_inputs(dtype, 256, 102, card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm-up, as torch asks
        for _ in range(2):
            chol.tri_pair_batched(chol.chol_batched(H), rhs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        L = chol.chol_batched(H)
        X = chol.tri_pair_batched(L, rhs)
    for seed in (None, 11):
        if seed is not None:
            H2, rhs2 = _batched_inputs(dtype, 256, 102, card, seed=seed)
            H.copy_(H2)
            rhs.copy_(rhs2)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(L, chol.chol_batched_plain(H))
        assert torch.equal(X, chol.tri_pair_batched_plain(L, rhs))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_non_pd_gives_non_finite_factor(card, dtype):
    """Every instance of a batch whose smallest eigenvalue is negative gets
    a non-finite factor, and the call returns."""
    H = _spd(7, 16, 102, neg=True) if dtype == torch.float64 else _spd32(7, 16, 102, neg=True)
    L = chol.chol_batched(torch.as_tensor(H, dtype=dtype, device=card))
    torch.cuda.synchronize()
    assert bool((~torch.isfinite(L)).flatten(1).any(1).all())


def test_kernels_refuse_what_they_cannot_hold(card):
    with pytest.raises(ValueError, match="blocked batched design.*queue 1 item 14"):
        chol.chol_batched(torch.eye(170, dtype=torch.float64, device=card)[None])
    # an empty factor launches nothing
    before = chol.chol_launches
    assert chol.chol_batched(torch.zeros(4, 0, 0, dtype=torch.float64,
                                         device=card)).shape == (4, 0, 0)
    assert chol.chol_launches == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_routers_send_large_batched_orders_to_the_single_kernels(card, dtype):
    """B = 2 at n = 200 (f64) / 250 (f32), above what the batched kernels
    take: the routers factor and solve an instance at a time through the
    single kernels, bit-equal to two single calls; no batched launch."""
    n = 200 if dtype == torch.float64 else 250
    suffix = "" if dtype == torch.float64 else "_f32"
    H = _spd(n, 2, n) if dtype == torch.float64 else _spd32(n, 2, n)
    H = torch.as_tensor(H, dtype=dtype, device=card)
    rhs = torch.as_tensor(np.random.default_rng(3).standard_normal((2, n, 3)),
                          dtype=dtype, device=card)
    names = [f"{c}{suffix}" for c in ("chol_launches", "tri_pair_launches",
                                      "chol_single_launches",
                                      "tri_pair_single_launches")]
    before = [getattr(chol, c) for c in names]
    L = chol.cholesky(H)
    X = chol.tri_pair_solve(L, rhs)
    delta = [getattr(chol, c) - b for c, b in zip(names, before)]
    assert delta == [0, 0, 2, 2]
    assert torch.equal(L, torch.stack([chol.chol_single(h) for h in H]))
    assert torch.equal(X, torch.stack([chol.tri_pair_single(a, b)
                                       for a, b in zip(L, rhs)]))


def test_card_block_solve_matches_reference(card):
    """Config 4's block shape at K = 32 through the port's solve_block on
    the card (default device) against the reference's on a 1-device mesh:
    the same status and iterations, pcost and dcost within 1e-9, the
    iterates within 1e-6; each factor is 1 chol_batched (the blocks), 1
    chol_single (the Schur complement), 9 tri_pair_batched and 4
    tri_pair_single."""
    from socp_tpu.parallel.mesh import block_mesh
    from socp_tpu.parallel.schur import random_block_problem, solve_block
    from socp_tpu.problem import ConeDims
    from socp_tpu_torch.parallel.schur import solve_block as port_solve_block

    prob, _ = random_block_problem(0, K=32, nb=10, p=8,
                                   block_dims=ConeDims(l=4, qs=(6,)))
    ref = solve_block(prob, mesh=block_mesh(1))
    counts = ("chol_launches", "chol_single_launches", "tri_pair_launches",
              "tri_pair_single_launches", "chol_launches_f32",
              "tri_pair_launches_f32")
    before = [getattr(chol, c) for c in counts]
    out = port_solve_block(prob)
    launches = [getattr(chol, c) - b for c, b in zip(counts, before)]
    assert out[4] == ref[4] == socp_tpu_torch.Status.OPTIMAL
    assert out[5] == ref[5]
    for j in (0, 1):
        assert abs(out[6][j] - ref[6][j]) <= 1e-9 * max(1.0, abs(ref[6][j]))
    for i in range(4):
        np.testing.assert_allclose(out[i], ref[i], rtol=0, atol=1e-6)
    factors = out[5] + 2
    assert launches == [factors, factors, 9 * factors, 4 * factors, 0, 0]


@pytest.mark.parametrize("case", ["multi_soc_3", "huge_soc_0"])
def test_card_hugecone_matches_cpu(card, case, monkeypatch):
    """tests/test_hugecone.py's multi-SOC (p = 2) and huge-SOC (p = 0)
    fixtures through the port's prepare_huge on the card (default device)
    against its CPU path: the same status and iterations, pcost within
    1e-10; each loop body and the W = I start launch 1 chol_single and 4
    tri_pair_single (p = 0) or 2 and 13 (p > 0), and nothing else; the
    solve synchronizes with the host only at its reads, one a body
    (torch.cuda's sync debug mode counts them)."""
    import warnings

    from socp_tpu_torch.parallel import hugecone as hc
    from test_torch_hugecone import SHAPES

    prob = SHAPES[case]()
    args = (prob.c, prob.G, prob.h, prob.dims.l, prob.dims.qs)
    reads = []
    fetch = hc._fetch
    monkeypatch.setattr(hc, "_fetch", lambda f: (reads.append(1), fetch(f))[1])
    counts = ("chol_single_launches", "tri_pair_single_launches",
              "chol_launches", "tri_pair_launches", "chol_launches_f32",
              "tri_pair_launches_f32", "chol_single_launches_f32",
              "tri_pair_single_launches_f32")
    fn, dev_args, assemble = hc.prepare_huge(*args, A=prob.A, b=prob.b)
    torch.cuda.synchronize()
    before = [getattr(chol, c) for c in counts]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            raw = fn(*dev_args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    launches = [getattr(chol, c) - b for c, b in zip(counts, before)]
    syncs = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    n_reads = len(reads)                   # the card's loop bodies
    out = assemble(raw)
    cpu = hc.solve_huge(*args, A=prob.A, b=prob.b, device="cpu")
    assert out[4] == cpu[4] == socp_tpu_torch.Status.OPTIMAL
    assert out[5] == cpu[5] and n_reads == out[5] + 1
    assert len(syncs) == n_reads, [str(w.message) for w in syncs]
    assert abs(out[6][0] - cpu[6][0]) <= 1e-10 * max(1.0, abs(cpu[6][0]))
    per_chol, per_tri = (2, 13) if prob.p else (1, 4)
    factors = n_reads + 1                  # and the W = I start
    assert launches == [per_chol * factors, per_tri * factors, 0, 0, 0, 0, 0, 0]


def test_card_admm_matches_reference(card):
    """Config 5's scenario shape at S = 64 (scenario_portfolio(0, n=20)),
    10 rounds of the port's admm_consensus on the card (default device)
    against the reference's on the CPU: the same rounds, rho and inner
    status, w_bar, x and the objective within 1e-8 (the card's products
    sum in another order than XLA's); each inner IPM iteration launches 2
    chol_batched and 10 tri_pair_batched, the first round's cold starts 2
    and 13 more, and nothing else."""
    from socp_tpu.models.stochastic import scenario_portfolio
    from socp_tpu.parallel.admm import admm_consensus
    from socp_tpu_torch.parallel.admm import admm_consensus as port_admm

    c, G, h, dims, A, b, info = scenario_portfolio(0, n=20, n_scenarios=64)
    kw = dict(n_consensus=info["n"], A=A, b=b, rho=1.0, outer_iters=10)
    ref = admm_consensus(c, G, h, dims, **kw)
    counts = ("chol_launches", "tri_pair_launches", "chol_single_launches",
              "tri_pair_single_launches", "chol_launches_f32",
              "tri_pair_launches_f32")
    before = [getattr(chol, name) for name in counts]
    out = port_admm(c, G, h, dims, **kw)
    chols, tris, *others = (getattr(chol, name) - n
                            for name, n in zip(counts, before))
    assert out.inner_status_ok and ref.inner_status_ok
    assert (out.outer_iterations, out.rho) == (ref.outer_iterations, ref.rho)
    np.testing.assert_allclose(out.w_bar, ref.w_bar, rtol=0, atol=1e-8)
    np.testing.assert_allclose(out.x, ref.x, rtol=0, atol=1e-8)
    assert abs(out.objective - ref.objective) <= 1e-8
    assert others == [0, 0, 0, 0]
    assert chols > 2 and tris - 13 == 5 * (chols - 2)


def test_card_native_dd_solve_matches_reference(card):
    """robust_ls_batch(0, 8, n=16, k=24) with native_dd on the card (the
    ConstGram assembly) against the reference, through the batched f64
    kernels in the loop's ratios."""
    data = dict(_cases())["robust_ls"]
    ref = socp_tpu.solve_batch_raw(**data)
    counts = ("chol_launches", "tri_pair_launches", "chol_launches_f32",
              "chol_single_launches")
    before = [getattr(chol, c) for c in counts]
    out = socp_tpu_torch.solve_batch_raw(
        **data, config=socp_tpu_torch.SolverConfig(native_dd=True,
                                                   factor_dtype="float32"))
    chols, tris, c32, cs = (getattr(chol, c) - b for c, b in zip(counts, before))
    assert c32 == cs == 0 and chols >= 2 and tris == 3 * chols + 1
    np.testing.assert_array_equal(out[4], np.asarray(ref[4]))
    rp = np.asarray(ref[6])[:, 0]
    assert np.all(np.abs(out[6][:, 0] - rp) <= 1e-8 * np.maximum(1.0, np.abs(rp)))


# n: both sides of the panel and tile edges (32) and of the one-block
# limits of the kernels before (169 in f64, 240 in f32), and the paths'
# sizes (8: config 4's Schur factor); k: both sides of the pair kernel's 4
# columns a pass, and 8
SINGLE_NS = [1, 2, 8, 31, 32, 33, 64, 65, 169, 170, 240, 241, 500, 768, 1000]
SINGLE_KS = [1, 5, 8, 9]


@pytest.mark.parametrize("n", SINGLE_NS)
def test_chol_single_kernel_matches_plain(card, n):
    """One tile (the walker alone) and the tile dataflow round as the plain
    column loop does: bit for bit."""
    H = torch.as_tensor(_spd(n, 1, n)[0], device=card)
    before = chol.chol_single_launches
    L = chol.chol_single(H)
    assert chol.chol_single_launches == before + 1
    assert torch.equal(L, chol.chol_single_plain(H))


@pytest.mark.parametrize("n,k", [(n, k) for n in SINGLE_NS for k in SINGLE_KS])
def test_tri_pair_single_kernel_matches_plain(card, n, k):
    """Every (n, k) of configs 1 and 2 (p = 5: (50, 5), (5, 1)) lies among
    these; k = 5, 8 and 9 take two or three passes over the rhs columns (4
    a pass)."""
    L = chol.chol_single(torch.as_tensor(_spd(n + k, 1, n)[0], device=card))
    rhs = torch.as_tensor(np.random.default_rng(k).standard_normal((n, k)),
                          device=card)
    before = chol.tri_pair_single_launches
    X = chol.tri_pair_single(L, rhs)
    assert chol.tri_pair_single_launches == before + 1
    assert torch.equal(X, chol.tri_pair_single_plain(L, rhs))


def _single_inputs(dtype, n, k, card, seed=None):
    seed = n if seed is None else seed
    if dtype == torch.float64:
        H = _spd(seed, 1, n)[0]
    else:
        H = _spd32(seed, 1, n)[0]
    rhs = np.random.default_rng(k).standard_normal((n, k))
    return (torch.as_tensor(H, dtype=dtype, device=card),
            torch.as_tensor(rhs, dtype=dtype, device=card))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [50, 500])
def test_single_kernels_back_to_back_calls_give_the_same_bits(card, dtype, n):
    """Calls queued on one stream with no sync between them: the tile
    dataflow's flags are per call, so no call reads another's."""
    H, rhs = _single_inputs(dtype, n, 1, card)
    Ls = [chol.chol_single(H) for _ in range(3)]
    Xs = [chol.tri_pair_single(L, rhs) for L in Ls]
    torch.cuda.synchronize()
    for L, X in zip(Ls[1:], Xs[1:]):
        assert torch.equal(L, Ls[0]) and torch.equal(X, Xs[0])
    assert torch.equal(Ls[0], chol.chol_single_plain(H))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_single_kernels_replay_in_a_cuda_graph(card, dtype):
    """chol_single then tri_pair_single at n = 500 captured by
    torch.cuda.graph (the scratch memset and both launches), replayed on
    the captured inputs and on new ones written into them: bit-equal to the
    plain versions."""
    H, rhs = _single_inputs(dtype, 500, 1, card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm-up, as torch asks
        for _ in range(2):
            chol.tri_pair_single(chol.chol_single(H), rhs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        L = chol.chol_single(H)
        X = chol.tri_pair_single(L, rhs)
    for seed in (None, 11):
        if seed is not None:
            H2, rhs2 = _single_inputs(dtype, 500, 1, card, seed=seed)
            H.copy_(H2)
            rhs.copy_(rhs2)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(L, chol.chol_single_plain(H))
        assert torch.equal(X, chol.tri_pair_single_plain(L, rhs))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_div_rn_is_the_cards_division(card, dtype):
    """div_rn (csrc/div_rn.cuh), the division on the single kernels'
    chains, returns x / p bit for bit: random bit patterns (zeros,
    subnormals, infinities, NaNs) and normal pairs across the exponent
    range, both signs."""
    from socp_tpu_torch.ops import _build

    size = torch.finfo(dtype).bits // 8
    g = torch.Generator(device=card)
    g.manual_seed(3)
    count = 1 << 20

    def bits():
        return torch.randint(0, 256, (count * size,), device=card,
                             generator=g, dtype=torch.uint8).view(dtype)

    def normal():
        top = 1000 if size == 8 else 125
        e = torch.randint(-top, top, (count,), device=card, generator=g)
        m = torch.rand(count, device=card, generator=g, dtype=torch.float64)
        s = torch.randint(0, 2, (count,), device=card, generator=g) * 2 - 1
        return (s * (1 + m) * torch.pow(2.0, e.double())).to(dtype)

    x, p = torch.cat([bits(), normal()]), torch.cat([bits(), normal()])
    out = torch.empty_like(x)
    entry = _build.kernel("div_rn_f64" if size == 8 else "div_rn_f32")
    assert entry(x.data_ptr(), p.data_ptr(), out.data_ptr(), x.numel(),
                 torch.cuda.current_stream().cuda_stream) == 0
    want = x / p
    ints = torch.int64 if size == 8 else torch.int32
    same = (out.view(ints) == want.view(ints)) | (out.isnan() & want.isnan())
    assert bool(same.all())


@pytest.mark.parametrize("n", [20, 102, 500])
def test_single_non_pd_gives_non_finite_factor(card, n):
    """One tile, then the dataflow; the call returns (no tile waits forever
    on a NaN pivot's flag)."""
    L = chol.chol_single(torch.as_tensor(_spd(7, 1, n, neg=True)[0], device=card))
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(L).all())


def _cases():
    c, G, h, dims = robust_ls_batch(0, 8, n=16, k=24)
    yield "robust_ls", dict(c=c, G=G, h=h, dims=dims)
    probs = [random_socp(s, n=20, l=6, qs=(4, 6), p=3)[0] for s in range(4)]
    stack = lambda f: np.stack([getattr(pr, f) for pr in probs])
    yield "with_A", dict(c=stack("c"), G=stack("G"), h=stack("h"),
                         dims=probs[0].dims, A=stack("A"), b=stack("b"))


@pytest.mark.parametrize("case", ["robust_ls", "with_A"])
def test_card_solve_matches_reference(card, case):
    data = dict(_cases())[case]
    ref = socp_tpu.solve_batch_raw(**data)
    c0, t0 = chol.chol_launches, chol.tri_pair_launches
    out = socp_tpu_torch.solve_batch_raw(**data)          # default device: cuda
    chols, tris = chol.chol_launches - c0, chol.tri_pair_launches - t0
    np.testing.assert_array_equal(out[4], np.asarray(ref[4]))
    rp = np.asarray(ref[6])[:, 0]
    rel = np.abs(out[6][:, 0] - rp) / np.maximum(1.0, np.abs(rp))
    assert np.all(rel <= 1e-8), rel
    if case == "robust_ls":
        # p = 0: init 1 Cholesky + 4 pair solves; per iteration 1 + 3
        assert chols >= 2 and tris == 3 * chols + 1
    else:
        # p > 0: a factor is 2 Cholesky + 1 pair solve (H^-1 A'), a
        # back-solve 3 pair solves; init 2 + 13, per iteration 2 + 10
        assert chols >= 4 and chols % 2 == 0 and tris == 5 * chols + 3


@pytest.mark.parametrize("case", ["config1_n50", "portfolio_n64"])
def test_card_single_solve_matches_reference(card, case):
    """socp_tpu_torch.solve on the card through the single kernels only."""
    from socp_tpu.models.portfolio import portfolio
    from socp_tpu_torch.carry import problem_from_reference

    if case == "config1_n50":
        prob = random_socp(0, n=50, l=10, qs=(10, 14, 20))[0]
    else:
        prob = portfolio(0, n=64, k=8)[0]
    ref = socp_tpu.solve(prob)
    counts = ("chol_launches", "tri_pair_launches", "chol_single_launches",
              "tri_pair_single_launches")
    before = [getattr(chol, c) for c in counts]
    out = socp_tpu_torch.solve(problem_from_reference(prob))  # default: cuda
    chols_b, tris_b, chols, tris = (getattr(chol, c) - b
                                    for c, b in zip(counts, before))
    assert out.status == int(ref.status) == 0
    assert abs(out.pcost - ref.pcost) <= 1e-8 * max(1.0, abs(ref.pcost))
    assert chols_b == tris_b == 0
    # p > 0: init 2 Cholesky + 13 pair solves, per iteration 2 + 10
    assert chols >= 4 and chols % 2 == 0 and tris == 5 * chols + 3
    assert out.iterations <= chols // 2 - 1 <= out.iterations + 1


# ---- the f32 instances (factor_dtype="float32") and the probes ----------


def _spd32(seed, B, n, neg=False):
    """kappa 1e4: f32 cannot factor the f64 tests' 1e8."""
    return np.asarray(_spd(seed, B, n, kappa=1e4, neg=neg), np.float32)


# (B, n) in f32: as BATCHED_F64, up to n = 240, the largest the wrapper takes
BATCHED_F32 = [(256, 102), (8, 240), (4, 1), (64, 2), (64, 5), (64, 31),
               (64, 32), (64, 33), (64, 65), (64, 108), (64, 109), (16, 169),
               (4096, 102)]


@pytest.mark.parametrize("B,n", BATCHED_F32)
def test_f32_chol_batched_bit_equal_to_plain(card, B, n):
    """n = 240 is the largest order the wrapper takes in f32."""
    H = torch.as_tensor(_spd32(n, B, n), device=card)
    before = (chol.chol_launches, chol.chol_launches_f32)
    L = chol.chol_batched(H)
    assert (chol.chol_launches, chol.chol_launches_f32) == (before[0], before[1] + 1)
    assert L.dtype == torch.float32
    assert torch.equal(L, chol.chol_batched_plain(H))


@pytest.mark.parametrize("B,n,k", [(256, 102, 1), (8, 240, 1), (8, 37, 3)]
                         + [(B, n, k) for B, n in BATCHED_F32[2:] for k in (1, 3)]
                         + [(8, 240, 3)])
def test_f32_tri_pair_batched_bit_equal_to_plain(card, B, n, k):
    """k = 3 at n = 240 is new: one block no longer holds the rhs beside L."""
    L = chol.chol_batched(torch.as_tensor(_spd32(n + k, B, n), device=card))
    rhs = torch.as_tensor(np.random.default_rng(k).standard_normal((B, n, k)),
                          dtype=torch.float32, device=card)
    before = chol.tri_pair_launches_f32
    X = chol.tri_pair_batched(L, rhs)
    assert chol.tri_pair_launches_f32 == before + 1
    assert torch.equal(X, chol.tri_pair_batched_plain(L, rhs))


@pytest.mark.parametrize("n", SINGLE_NS)
def test_f32_chol_single_bit_equal_to_plain(card, n):
    """As the f64 instance: one tile, then the tile dataflow."""
    H = torch.as_tensor(_spd32(n, 1, n)[0], device=card)
    before = chol.chol_single_launches_f32
    L = chol.chol_single(H)
    assert chol.chol_single_launches_f32 == before + 1
    assert torch.equal(L, chol.chol_single_plain(H))


@pytest.mark.parametrize("n,k", [(n, k) for n in SINGLE_NS for k in SINGLE_KS])
def test_f32_tri_pair_single_bit_equal_to_plain(card, n, k):
    L = chol.chol_single(torch.as_tensor(_spd32(n + k, 1, n)[0], device=card))
    rhs = torch.as_tensor(np.random.default_rng(k).standard_normal((n, k)),
                          dtype=torch.float32, device=card)
    before = chol.tri_pair_single_launches_f32
    X = chol.tri_pair_single(L, rhs)
    assert chol.tri_pair_single_launches_f32 == before + 1
    assert torch.equal(X, chol.tri_pair_single_plain(L, rhs))


@pytest.mark.parametrize("n", [20, 102, 500])
def test_f32_non_pd_gives_non_finite_factor(card, n):
    L = chol.chol_single(torch.as_tensor(_spd32(7, 1, n, neg=True)[0], device=card))
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(L).all())


def test_mixed_dtypes_and_oversized_f32_batches_raise(card):
    L64 = torch.eye(4, dtype=torch.float64, device=card)
    with pytest.raises(TypeError, match="float64.*float32"):
        chol.tri_pair_single(L64, torch.ones(4, 1, device=card))
    with pytest.raises(TypeError, match="float64.*float32"):
        chol.tri_pair_batched(L64[None], torch.ones(1, 4, 1, device=card))
    with pytest.raises(ValueError, match="blocked batched design"):
        chol.chol_batched(torch.eye(241, device=card)[None])


def test_card_f32factor_solve_matches_reference(card):
    """robust_ls_batch(0, 8, n=16, k=24) with factor_dtype="float32" on the
    card through the f32 batched kernels only; held as
    tests/test_torch_f32factor.py holds the CPU path (every lane ends
    optimal, inaccurate there)."""
    data = dict(_cases())["robust_ls"]
    ref = socp_tpu.solve_batch_raw(**data, config=socp_tpu.SolverConfig(
        factor_dtype="float32"))
    counts = ("chol_launches", "tri_pair_launches", "chol_launches_f32",
              "tri_pair_launches_f32")
    before = [getattr(chol, c) for c in counts]
    out = socp_tpu_torch.solve_batch_raw(
        **data, config=socp_tpu_torch.SolverConfig(factor_dtype="float32"))
    c64, t64, c32, t32 = (getattr(chol, c) - b for c, b in zip(counts, before))
    assert c64 == t64 == 0 and c32 >= 2 and t32 == 3 * c32 + 1
    np.testing.assert_array_equal(out[4], np.asarray(ref[4]))
    np.testing.assert_array_equal(out[6][:, 6], np.asarray(ref[6])[:, 6])
    rp = np.asarray(ref[6])[:, 0]
    assert np.all(np.abs(out[6][:, 0] - rp) <= 5e-5 * np.maximum(1.0, np.abs(rp)))


@pytest.mark.parametrize("n,k", [(128, 1), (128, 4), (100, 1), (100, 4),
                                 (33, 1), (33, 4)])
def test_probe_fwd_bit_equal_to_plain(card, n, k):
    """The redesigned probe_fwd (a warp a column, 32-row blocks): at P5's
    (128, 128) and at orders off the blocks, and with a zero, a negative
    zero, a subnormal, a huge value and a NaN in b (the kernel's IEEE second
    pass), where NaNs and the signs of zeros agree too."""
    rng = np.random.default_rng(n + k)
    A = rng.normal(size=(n, n))
    L = np.linalg.cholesky(A @ A.T + n * np.eye(n)).astype(np.float32)
    LT = torch.as_tensor(L.T.copy(), device=card)
    b = torch.as_tensor(rng.normal(size=(n, k)).astype(np.float32), device=card)
    before = probes.launches["probe_fwd"]
    assert torch.equal(probes.fwd_subst(LT, b), probes.fwd_subst_plain(LT, b))
    assert probes.launches["probe_fwd"] == before + 1
    for val in (0.0, -0.0, 1e-40, 3e38, float("nan")):
        bv = b.clone()
        bv[n // 3, k - 1] = val
        got, want = probes.fwd_subst(LT, bv), probes.fwd_subst_plain(LT, bv)
        same = ((got.view(torch.int32) == want.view(torch.int32))
                | (got.isnan() & want.isnan()))
        assert bool(same.all()), val
    with pytest.raises(ValueError, match="outside the kernel's"):
        probes.fwd_subst(torch.eye(513, device=card),
                         torch.ones(513, 1, device=card))


F32_COUNTS = ("chol_launches", "tri_pair_launches", "chol_single_launches",
              "tri_pair_single_launches", "chol_launches_f32",
              "tri_pair_launches_f32", "chol_single_launches_f32",
              "tri_pair_single_launches_f32")


def _f32_hold(card_out, cpu_out):
    """(status, pcost) of the card against the CPU's plain path: the same
    status, pcost within 5e-5 relative (iterations and the inaccurate flag
    may differ with the order of the f32 sums)."""
    assert card_out[0] == cpu_out[0]
    assert abs(card_out[1] - cpu_out[1]) <= 5e-5 * max(1.0, abs(cpu_out[1]))


@pytest.mark.parametrize("case", ["robust_ls", "with_A"])
def test_card_f32carry_batch_matches_cpu(card, case):
    """dtype=float32 through solve_batch_raw on the card: f32 carries and
    only the f32 batched kernels, held to the same call on the CPU's
    plain path at the f32 tolerances."""
    data = dict(_cases())[case]
    before = [getattr(chol, c) for c in F32_COUNTS]
    out = socp_tpu_torch.solve_batch_raw(**data, dtype=torch.float32)
    d = dict(zip(F32_COUNTS, (getattr(chol, c) - v
                              for c, v in zip(F32_COUNTS, before))))
    assert d["chol_launches_f32"] >= 2 and d["tri_pair_launches_f32"] >= 4
    assert sum(d.values()) == d["chol_launches_f32"] + d["tri_pair_launches_f32"]
    cpu = socp_tpu_torch.solve_batch_raw(**data, dtype=torch.float32,
                                         device="cpu")
    for i in range(len(out[4])):
        _f32_hold((out[4][i], out[6][i, 0]), (cpu[4][i], cpu[6][i, 0]))
    assert np.array_equal(out[0], out[0].astype(np.float32))


def test_card_f32carry_solve_matches_cpu(card):
    """solve at dtype=float32 on the card: only the single f32 kernels,
    held to the CPU's plain path as above."""
    from socp_tpu_torch.carry import problem_from_reference

    prob = problem_from_reference(random_socp(2, n=30, l=8, qs=(4, 6, 10),
                                              p=5)[0])
    before = [getattr(chol, c) for c in F32_COUNTS]
    sol = socp_tpu_torch.solve(prob, dtype=np.float32)
    d = dict(zip(F32_COUNTS, (getattr(chol, c) - v
                              for c, v in zip(F32_COUNTS, before))))
    assert d["chol_single_launches_f32"] >= 4
    assert sum(d.values()) == (d["chol_single_launches_f32"]
                               + d["tri_pair_single_launches_f32"])
    cpu = socp_tpu_torch.solve(prob, dtype=np.float32, device="cpu")
    _f32_hold((sol.status, sol.pcost), (cpu.status, cpu.pcost))


@pytest.mark.parametrize("name", ["portfolio", "batched_robust_ls"])
def test_card_example_matches_its_cpu_run(card, name):
    """socp_tpu_torch/examples/ on the card against the same call on the
    CPU's plain path: status, iterations and pcost within 1e-9 relative.
    batched_robust_ls takes the native_dd route on the card, and its CPU
    run is given the same config."""
    from socp_tpu_torch.examples import batched_robust_ls, portfolio

    if name == "portfolio":
        r = portfolio.run(verbose=False)
        cpu = portfolio.run(verbose=False, device="cpu")
        card_out = (r["status"], r["iterations"], r["pcost"])
        cpu_out = (cpu["status"], cpu["iterations"], cpu["pcost"])
        pairs = [(card_out, cpu_out)]
    else:
        r = batched_robust_ls.run(B=16)
        assert r["config"].native_dd and r["optimal"] == 16
        out = r["out"]
        cpu = socp_tpu_torch.solve_batch_raw(*r["data"], config=r["config"],
                                             device="cpu")
        pairs = [((out[4][i], out[5][i], out[6][i, 0]),
                  (cpu[4][i], cpu[5][i], cpu[6][i, 0])) for i in range(16)]
    assert r["device"] == torch.cuda.get_device_name(0)
    for (status, iters, pcost), (c_status, c_iters, c_pcost) in pairs:
        assert int(status) == int(c_status) and int(iters) == int(c_iters)
        assert abs(pcost - c_pcost) <= 1e-9 * max(1.0, abs(c_pcost))


def test_probe_kernels_bit_equal_to_plain(card):
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.normal(size=(8, 128)), dtype=torch.float32, device=card)
    b = torch.as_tensor(rng.normal(size=(8, 128)) * 1e-3, dtype=torch.float32,
                        device=card)
    for o, r in zip(probes.eft(a, b), probes.eft_plain(a, b)):
        assert torch.equal(o, r)
    M = torch.arange(64 * 64, dtype=torch.float32, device=card).reshape(64, 64)
    assert torch.equal(probes.row_sum(M), probes.row_sum_plain(M))
    assert torch.equal(probes.row_reverse(M), M.flip(0))
    L = torch.linalg.cholesky(torch.as_tensor(_spd32(5, 1, 128)[0], device=card))
    LT = L.T.contiguous()
    bb = torch.ones(128, 1, device=card)
    assert torch.equal(probes.fwd_subst(LT, bb), probes.fwd_subst_plain(LT, bb))


# ---- the multi-device layer on a one-rank NCCL group ---------------------

@pytest.fixture(scope="module")
def nccl_world():
    """A world of one rank on NCCL (parallel/runtime.py), torn down after
    the module; every collective of a group of one is still a NCCL call."""
    import socket

    import torch.distributed as dist

    from socp_tpu_torch.parallel.runtime import init_distributed

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(0, 1, f"tcp://127.0.0.1:{port}", device="cuda:0")
    assert dist.get_backend() == "nccl"
    yield
    dist.destroy_process_group()


def test_collectives_on_one_nccl_rank_equal_the_local_op(card, nccl_world):
    from socp_tpu_torch.parallel import collectives as coll
    from socp_tpu_torch.parallel.mesh import batch_mesh, mesh_group

    group = mesh_group(batch_mesh(1))
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 12)),
                        device=card)
    coll.reset_counts()
    assert torch.equal(coll.psum(x, group), x)
    assert torch.equal(coll.pmin(x, group), x)
    assert torch.equal(coll.allsum(x, group), x)
    for chunks in (1, 3, 5):
        assert torch.equal(coll.ring_allreduce(x, group, n_chunks=chunks), x)
    assert torch.equal(coll.all_gather(x, group), x[None])
    assert bool(coll.pany(torch.tensor(True, device=card), group))
    assert not bool(coll.pany(torch.tensor(False, device=card), group))
    assert coll.counts() == {"psum": 1, "pmin": 1, "pany": 2, "all_gather": 1,
                             "allsum": 1, "ring_allreduce": 3, "staged": 0}


def test_block_solve_on_one_nccl_rank_is_bit_equal(card, nccl_world):
    """Config 4's block shape at K = 32, with and without ring_schur:
    solve_block over a one-rank mesh gives the bits of mesh=None, through
    NCCL collectives."""
    from socp_tpu_torch.parallel import collectives as coll
    from socp_tpu_torch.parallel.mesh import block_mesh
    from socp_tpu_torch.parallel.schur import random_block_problem, solve_block
    from socp_tpu_torch.problem import ConeDims

    prob, _ = random_block_problem(0, K=32, nb=10, p=8,
                                   block_dims=ConeDims(l=4, qs=(6,)))
    for ring in (False, True):
        cfg = socp_tpu_torch.SolverConfig(ring_schur=ring)
        alone = solve_block(prob, config=cfg)
        coll.reset_counts()
        meshed = solve_block(prob, config=cfg, mesh=block_mesh(1))
        counts = coll.counts()
        assert alone[4] == socp_tpu_torch.Status.OPTIMAL
        for a, b in zip(alone, meshed):
            assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
        assert counts["psum"] > 0 and counts["pmin"] > 0
        assert (counts["ring_allreduce"] > 0) == ring
