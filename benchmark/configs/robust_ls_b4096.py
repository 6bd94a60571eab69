"""BASELINE config 3: a batch of 4096 independent robust least-squares
SOCPs of n = 100 (k = 2n = 200 residual rows, rho = 0.1), certified to
1e-8, as `bench.py:267` runs `robust_ls_batch(0, batch=4096, n=100)`.

    minimize ||D x - d|| + rho ||x||  over (x, t1, t2):
    minimize t1 + rho t2  s.t.  ||D x - d|| <= t1,  ||x|| <= t2

nv = n + 2 = 102 variables, m = (k + 1) + (n + 1) = 302 rows in two SOCs,
no equality rows.  The construction is `socp_tpu_torch/models/robust_ls.py`'s
(D ~ N(0, 1)/sqrt(n), x0 ~ N(0, 1), d = D x0 + 0.1 N(0, 1)), drawn here for
the whole pool in one pass on the device from the seed, not instance by
instance on the host; the conic rows are the same.
"""

from __future__ import annotations

import math

import torch

from benchmark.harness import roofline
from benchmark.reference import robust_ls as ref

NAME = "robust_ls_b4096"
SOURCE = ('https://github.com/BenChung/Socp.jl robust least squares; '
          'Lobo, Vandenberghe, Boyd, Lebret 1998, Applications of SOCP, '
          'sec 3.3; BASELINE config 3: 4096 x n=100')
SHAPES = {"batch": 4096, "n": 100, "k": 200}
RHO = 0.1
SOLVER = {}            # SolverConfig() as it stands: f64, every tolerance 1e-8
BUCKET_MULTIPLE = 8    # SolverConfig.bucket_multiple, the SOC padding granule
REDUCED = []
ASSUMED = {
    "draws": "one torch.Generator on the device seeded with --seed draws D, "
             "x0 and the noise of every batch of the pool; the models/ "
             "generator seeds numpy per instance",
}


def _sizes(sizes):
    B = sizes.get("batch", SHAPES["batch"])
    n = sizes.get("n", SHAPES["n"])
    return B, n, sizes.get("k", 2 * n)


def draw(seed, batches, batch, n, k, device):
    """D (batches, batch, k, n) and d (batches, batch, k) from the seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device, generator=gen)
    D = torch.randn(batches, batch, k, n, **f64) / math.sqrt(n)
    x0 = torch.randn(batches, batch, n, 1, **f64)
    d = (D @ x0)[..., 0] + 0.1 * torch.randn(batches, batch, k, **f64)
    return D, d


def conic(D, d, rho=RHO):
    """(c, G, h) of the conic form for (B, k, n) D and (B, k) d, rows SOC1
    (t1, Dx - d) then SOC2 (t2, x), as models/robust_ls.py lays them."""
    B, k, n = D.shape
    G = D.new_zeros((B, k + n + 2, n + 2))
    h = D.new_zeros((B, k + n + 2))
    G[:, 0, n] = -1.0
    G[:, 1:k + 1, :n] = -D
    h[:, 1:k + 1] = -d
    G[:, k + 1, n + 1] = -1.0
    G[:, k + 2:, :n] = -torch.eye(n, dtype=D.dtype, device=D.device)
    c = D.new_zeros((B, n + 2))
    c[:, n] = 1.0
    c[:, n + 1] = rho
    return c, G, h


def pool(seed, size, device, sizes):
    """`size` batches: each the program's inputs (numpy c, G, h and the
    cone dims) and the reference's (D, d on the device)."""
    from socp_tpu_torch import ConeDims

    B, n, k = _sizes(sizes)
    D, d = draw(seed, size, B, n, k, device)
    items = []
    for i in range(size):
        c, G, h = conic(D[i], d[i])
        items.append({"c": c.cpu().numpy(), "G": G.cpu().numpy(),
                      "h": h.cpu().numpy(),
                      "dims": ConeDims(l=0, qs=(k + 1, n + 1)),
                      "D": D[i], "d": d[i]})
        del c, G, h
    return items


def _unpad(v, k, n):
    index, _ = ref.padded_index(0, (k + 1, n + 1), BUCKET_MULTIPLE)
    return v[:, torch.as_tensor(index, device=v.device)]


def judge(records, device, sizes, traffic):
    """Every instance of every batch, against the reference (module doc of
    reference/robust_ls.py): the status; the certificate (pres, dres and
    min(gap, relgap)) recomputed from the data; and how far the answer's
    objective ||Dx - d|| + rho||x|| lies above the optimum, relative to
    max(1, |f*|)."""
    B, n, k = _sizes(sizes)
    optimum = {}
    out = {"not_optimal": 0.0, "pres": 0.0, "dres": 0.0, "gap": 0.0,
           "objective": 0.0}
    for r in records:
        item = r["item"]
        key = id(item)
        if key not in optimum:
            optimum[key] = ref.optimum(item["D"], item["d"], RHO)[1]
        fstar = optimum[key]
        x = r["x"].to(torch.float64)
        s = _unpad(r["s"].to(torch.float64), k, n)
        z = _unpad(r["z"].to(torch.float64), k, n)
        pres, dres, gap, relgap = ref.certificate(item["D"], item["d"], RHO, x, s, z)
        # status 0 is OPTIMAL in the program's output; stats[:, 6] flags an
        # answer accepted only at the relaxed tolerances
        bad = (r["status"] != 0) | (r["stats"][:, 6] != 0)
        f = ref.objective(item["D"], item["d"], RHO, x[:, :n])
        above = (f - fstar) / fstar.abs().clamp_min(1.0)
        for name, v in (("not_optimal", bad.sum().double()),
                        ("pres", pres.max()), ("dres", dres.max()),
                        ("gap", torch.minimum(gap, relgap).max()),
                        ("objective", above.max())):
            out[name] = _worst(out[name], float(v))
    return out


def _worst(a, b):
    """The larger reading; NaN, which no limit admits, wins."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def least_times(deltas, shapes, traffic):
    """(all launches, cheapest launch) least seconds of the port's batched
    kernels over a stretch: every launch factors or solves the whole batch
    at nv = n + 2, one rhs column (p = 0)."""
    B, nv = shapes["batch"], shapes["n"] + 2
    one_chol = roofline.chol_batched_s(B, nv)
    one_pair = roofline.tri_pair_batched_s(B, nv, 1)
    return {"chol_batched": (deltas["chol_batched"] * one_chol, one_chol),
            "tri_pair_batched": (deltas["tri_pair_batched"] * one_pair, one_pair)}


def reference_answer(item, dtype):
    """The reference put in the program's place, in `dtype`: the optimum of
    each instance in the program's output form (v, padded s and z)."""
    D, d = item["D"].to(dtype), item["d"].to(dtype)
    B, k, n = D.shape
    x, _ = ref.optimum(D, d, RHO)
    v, s, z = ref.conic_solution(D, d, RHO, x)
    index, m_pad = ref.padded_index(0, (k + 1, n + 1), BUCKET_MULTIPLE)
    idx = torch.as_tensor(index, device=D.device)
    sp = s.new_zeros((B, m_pad))
    zp = z.new_zeros((B, m_pad))
    sp[:, idx] = s
    zp[:, idx] = z
    stats = s.new_zeros((B, 7))
    return {"x": v, "s": sp, "z": zp,
            "status": torch.zeros(B, dtype=torch.int32, device=D.device),
            "stats": stats}
