"""BASELINE config 5: the two-stage stochastic portfolio, 65,536 return
scenarios of n = 20 assets (k = 4 risk factors), solved by consensus ADMM
with rho = 1 and the batched IPM inside, as `scripts/bench_all.py:177-200`
runs it (`scenario_portfolio(0, n=20, n_scenarios=S)`,
`admm_consensus(..., rho=1.0, outer_iters=10, config=...)` after a 2-round
warm-up call).

Each scenario's subproblem over x = (w (n), v): minimize -mu_i'w + kappa v
s.t. 1'w = 1, w >= 0, v >= 0, mu_i'w + v >= r_floor,
||(F'w, Dhalf w)|| <= sigma_max: nv = 21, m = 47 rows (22 orthant, one SOC
of 25), p = 1.  The consensus coordinates are w.

The deployment shards the scenarios over 16 chips (v5p-16); here all
65,536 are on one card, with no exchange between chips.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.harness import roofline
from benchmark.reference import admm as ref

NAME = "scenario_portfolio_s65536"
SOURCE = ('Boyd et al. 2011, Distributed Optimization and Statistical '
          'Learning via ADMM, sec 7.1 consensus; BASELINE config 5 '
          '(github.com/BenChung/Socp.jl): 65,536 scenarios, n=20, rho=1')
SHAPES = {"scenarios": 65536, "n": 20, "k": 4, "chips": 1}
SOLVER = {"factor_dtype": "dd32"}    # bench_all's config: the f64 factor here
ADMM = {"rho": 1.0, "tol": 1e-5}    # admm_consensus's tol default, as bench_all
MARKET_SEED = 0                      # bench_all's scenario_portfolio(0, ...)
REDUCED = ["chips"]
ASSUMED = {
    "chips": "16 in the deployment (v5p-16), each with 4,096 scenarios; "
             "here one card holds all 65,536 and runs no exchange",
    "seed": "the market (mean returns, factors, idiosyncratic risk) is "
            "bench_all's, drawn from seed 0; --seed draws the scenarios",
}


def market(rng, n, k):
    """The shared market of `socp_tpu_torch/models/stochastic.scenario_portfolio`
    (a frozen copy): mean returns, factor loadings, idiosyncratic risk."""
    mu_bar = 0.05 + 0.15 * rng.random(n)
    F = rng.normal(size=(n, k)) * (0.2 / np.sqrt(k))
    Dhalf = 0.05 + 0.15 * rng.random(n)
    return mu_bar, F, Dhalf


def scenarios(rng, mu_bar, n_scenarios):
    """The scenarios' mean returns, drawn after the market (frozen copy)."""
    n = mu_bar.shape[0]
    return mu_bar[None, :] + 0.1 * rng.normal(size=(n_scenarios, n)) / np.sqrt(n)


def build(mus, F, Dhalf, sigma_max=0.25, kappa=2.0, r_floor=0.05):
    """The scenario subproblems' arrays (frozen copy): (c (S, nv), G (S, m,
    nv), h (S, m), (l, qs), A (1, nv), b)."""
    n_scenarios, n = mus.shape
    k = F.shape[1]
    nv = n + 1
    m = n + 2 + (k + n + 1)
    G = np.zeros((n_scenarios, m, nv))
    h = np.zeros((n_scenarios, m))
    c = np.zeros((n_scenarios, nv))
    G[:, :n, :n] = -np.eye(n)                     # w >= 0
    G[:, n, n] = -1.0                             # v >= 0
    G[:, n + 1, :n] = -mus                        # mu'w + v >= r_floor
    G[:, n + 1, n] = -1.0
    h[:, n + 1] = -r_floor
    off = n + 2
    h[:, off] = sigma_max
    G[:, off + 1:off + 1 + k, :n] = -F.T
    G[:, off + 1 + k:, :n] = -np.diag(Dhalf)
    c[:, :n] = -mus
    c[:, n] = kappa
    A = np.zeros((1, nv))
    A[0, :n] = 1.0
    return c, G, h, (n + 2, (k + n + 1,)), A, np.array([1.0])


def scenario_portfolio(seed, n=20, k=4, n_scenarios=8):
    """`models/stochastic.scenario_portfolio(seed, n, k, n_scenarios)`: one
    generator draws the market, then the scenarios."""
    rng = np.random.default_rng(seed)
    mu_bar, F, Dhalf = market(rng, n, k)
    return build(scenarios(rng, mu_bar, n_scenarios), F, Dhalf)


def problem(seed, sizes):
    """The program's inputs and the reference's (the same arrays): the
    market of bench_all's instance (generator seed MARKET_SEED) and the
    scenarios drawn from `seed`, so that every seed poses the same market
    with a fresh sample of 65,536 return scenarios."""
    S = sizes.get("scenarios", SHAPES["scenarios"])
    n = sizes.get("n", SHAPES["n"])
    mu_bar, F, Dhalf = market(np.random.default_rng(MARKET_SEED), n,
                              sizes.get("k", SHAPES["k"]))
    c, G, h, (l, qs), A, b = build(
        scenarios(np.random.default_rng(seed), mu_bar, S), F, Dhalf)
    return {"c": c, "G": G, "h": h, "l": l, "qs": qs, "A": A, "b": b,
            "n_consensus": n}


def judge(records, device, sizes, traffic):
    """Every call of the window against one reference run of the same
    rounds from the same start (reference/admm.py): whether the call ran
    its rounds with every inner solve OPTIMAL and ended at the reference's
    rho; how far its reported residuals lie from the ones its own answer
    gives (`residual_relations`); and how far its w_bar and its last
    round's scenario solutions x lie from the reference's (the largest
    entry of |w_bar - w_ref|, the root mean square and the largest entry
    of x - x_ref), its objective (relative to max(1, |ref|)) and its
    residuals (relative).  Per scenario, and independent of the path by
    which an inner solve reached its optimum: `infeas`, the largest
    constraint violation of any scenario's last-round x, recomputed from
    the data (reference/admm.py `infeasibility`); and `sub_gap`, the
    largest gap between the last-round subproblem's objective at the
    program's x and at the reference's (the reference's own last-round
    subproblem, relative to max(1, |value|))."""
    if not records:
        return {}
    pb = records[0]["problem"]
    want = traffic["rounds"]
    r = ref.admm(pb["c"], pb["G"], pb["h"], pb["l"], pb["qs"], pb["n_consensus"],
                 pb["A"], pb["b"], rho=ADMM["rho"], rounds=want, tol=ADMM["tol"],
                 device=device)
    f_ref = ref.subproblem_value(r["c_last"], r["rho_last"], r["x"],
                                 pb["n_consensus"])
    out = {"calls_not_ok": 0.0, "pres_relation": 0.0, "dres_relation": 0.0,
           "infeas": 0.0, "sub_gap": 0.0,
           "w_bar": 0.0, "x_rms": 0.0, "x_max": 0.0, "objective": 0.0,
           "pres": 0.0, "dres": 0.0, "reference_unsolved": float(r["unsolved"])}
    for rec in records:
        res = rec["result"]
        bad = (not res.inner_status_ok) or res.outer_iterations != r["rounds"] \
            or res.rho != r["rho"]
        dx = res.x - r["x"]
        pres_rel, dres_rel = ref.residual_relations(
            res.x, res.w_bar, res.primal_res, res.dual_res, res.rho,
            pb["n_consensus"], tol=ADMM["tol"])
        for name, v in (
                ("calls_not_ok", float(bad)),
                ("pres_relation", pres_rel), ("dres_relation", dres_rel),
                ("infeas", ref.infeasibility(pb["G"], pb["h"], pb["l"], pb["qs"],
                                             pb["A"], pb["b"], res.x).max()),
                ("sub_gap", (np.abs(ref.subproblem_value(
                    r["c_last"], r["rho_last"], res.x, pb["n_consensus"]) - f_ref)
                    / np.maximum(1.0, np.abs(f_ref))).max()),
                ("w_bar", np.abs(res.w_bar - r["w_bar"]).max()),
                ("x_rms", math.sqrt(float(np.mean(dx * dx)))),
                ("x_max", np.abs(dx).max()),
                ("objective", abs(res.objective - r["objective"])
                 / max(1.0, abs(r["objective"]))),
                ("pres", abs(res.primal_res - r["pres"]) / r["pres"]),
                ("dres", abs(res.dual_res - r["dres"]) / r["dres"])):
            v = float(v)
            out[name] = (out[name] + v if name == "calls_not_ok" else
                         math.nan if math.isnan(v) or math.isnan(out[name])
                         else max(out[name], v))
    return out


def least_times(deltas, shapes, traffic):
    """(all launches, cheapest launch) least seconds of the port's batched
    kernels over a stretch of unchunked rounds.  With one equality row
    every factor pairs H (S, nv, nv) with the 1 x 1 Schur complement, and
    every KKT solve makes two pair solves with H and one with the Schur
    factor, beside the one in each factor (H^-1 A'): so half the
    Cholesky launches are at nv and half at 1, and (pair - factors / 2) / 3
    of the pair solves at 1, the rest at nv.  A count that does not fit
    that split gives no least time."""
    S, nv = shapes["scenarios"], shapes["n"] + 1
    out = {}
    f = deltas["chol_batched"]
    if f % 2 == 0:
        one = roofline.chol_batched_s(S, 1)
        out["chol_batched"] = (f // 2 * (roofline.chol_batched_s(S, nv) + one), one)
    pairs = deltas["tri_pair_batched"] - f // 2
    if f % 2 == 0 and pairs >= 0 and pairs % 3 == 0:
        solves = pairs // 3
        one = roofline.tri_pair_batched_s(S, 1, 1)
        at_nv = deltas["tri_pair_batched"] - solves
        out["tri_pair_batched"] = (
            at_nv * roofline.tri_pair_batched_s(S, nv, 1) + solves * one, one)
    return out
