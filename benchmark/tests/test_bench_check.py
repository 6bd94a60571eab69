"""The check that decides `correct`, shown to fail: the controls (the
nearest precision below the configuration's) and, for each fault a cell
can have, a run with the timed path broken underneath.  Each drives the
whole run but the look for a card, on the CPU at small sizes; the
`cuda` test runs the controls at the cells' own sizes."""

import pytest
import torch

from benchmark import control
from benchmark.harness import runner
from benchmark.harness.spec import Spec

SPEC = Spec()
SMALL = {"robust_ls_b4096": {"batch": 6, "n": 8},
         "scenario_portfolio_s65536": {"scenarios": 32}}
# the control of each cell: the program's own f32 path where it computes
# in f32; native_dd computes in f64 whatever its inputs, so the float32
# reference stands in the program's place there
CONTROLS = {"robust_ls_b4096.dense": "program_f32",
            "robust_ls_b4096.native_dd": "reference_f32",
            "scenario_portfolio_s65536.one_batch": "program_f32"}


def _sizes(cell):
    return SMALL[SPEC.cell(cell)["config"]]


def _run(cell, seed=11):
    return runner.run_cell(cell, seed, 0.2, False, device="cpu",
                           sizes=_sizes(cell))


@pytest.mark.parametrize("cell", sorted(CONTROLS))
def test_the_control_is_not_correct(cell):
    for seed in (1, 2**31 + 5, 3 * 10**9):
        readings, correct = control.control(cell, seed, 0.2, CONTROLS[cell],
                                            device="cpu", sizes=_sizes(cell))
        assert not correct, readings


# ---- faults planted in the program under the timed path

def _solve_faults(monkeypatch, fault):
    from socp_tpu_torch.ipm import driver
    from socp_tpu_torch.kkt import dense, structured

    if fault == "state_unchanged":
        # every Newton direction zero: each step returns its state
        for mod in (dense, structured):
            real = mod.solve_refined

            def zero(*a, _real=real, **k):
                dx, dy, dz, q = _real(*a, **k)
                return (torch.zeros_like(dx), torch.zeros_like(dy),
                        torch.zeros_like(dz), q)
            monkeypatch.setattr(mod, "solve_refined", zero)
        return
    real = driver.solve_core

    def broken(layout, cfg, c, G, h, A, b, P, **kw):
        if fault == "half_left_out":
            half = c.shape[0] // 2
            out = real(layout, cfg, c[:half], G[:half], h[:half], A[:half],
                       b[:half], P[:half] if P.ndim == 3 else P, **kw)
            return tuple(torch.cat([t, t[:c.shape[0] - half]]) for t in out)
        out = list(real(layout, cfg, c, G, h, A, b, P, **kw))
        x = out[0].clone()
        x[0, 0] += 1e-6 * max(1.0, float(x[0, 0].abs()))
        out[0] = x
        return tuple(out)
    monkeypatch.setattr(driver, "solve_core", broken)


def _admm_faults(monkeypatch, fault):
    """The consensus step broken: the round's state returned unchanged; the
    mean taken over half the scenarios; or its answer, w_bar, altered
    where it is produced.  Each computes its residuals as the step does."""
    from socp_tpu_torch.parallel import admm

    def broken(xc, u, w_bar, rho_d, alpha, ok, group=None, share=1.0):
        xh = alpha * xc + (1.0 - alpha) * w_bar[None, :]
        if fault == "state_unchanged":
            w_new, u_new = w_bar, u
        else:
            rows = xc.shape[0] // 2 if fault == "half_left_out" else xc.shape[0]
            w_new = torch.mean((xh + u)[:rows], dim=0)
            u_new = u + xh - w_new[None, :]
        pres = torch.sqrt(torch.mean(torch.sum((xc - w_new[None, :]) ** 2, dim=1)))
        dres = rho_d * torch.linalg.vector_norm(w_new - w_bar)
        if fault == "answer_altered":
            w_new = w_new.clone()
            w_new[0] += 1e-6
        return w_new, u_new, pres, dres, ok
    monkeypatch.setattr(admm, "_consensus", broken)


FAULTS = ("state_unchanged", "half_left_out", "answer_altered")


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", sorted(CONTROLS))
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    if SPEC.cell(cell)["config"].startswith("scenario"):
        _admm_faults(monkeypatch, fault)
    else:
        _solve_faults(monkeypatch, fault)
    result, readings = _run(cell)
    assert not result["correct"], readings


def test_a_few_scenarios_answered_wrong_are_not_correct(monkeypatch):
    """Config 5's inner solves with three scenarios' answers altered by
    1e-5 where they are produced: too few to move the rms of x, caught
    scenario by scenario."""
    from socp_tpu_torch.parallel import admm

    real = admm._inner

    def broken(*a, **k):
        x, ok, warm = real(*a, **k)
        x = x.clone()
        x[:3, 0] += 1e-5
        return x, ok, warm
    monkeypatch.setattr(admm, "_inner", broken)
    result, readings = _run("scenario_portfolio_s65536.one_batch")
    assert not result["correct"], readings
    for name in ("infeas", "sub_gap"):
        check = result["checks"][name]
        assert check["value"] > check["limit"], readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CONTROLS))
def test_the_control_at_the_cells_size_is_not_correct(cell, card):
    for seed in (101, 2**31 + 7, 4 * 10**9):
        readings, correct = control.control(cell, seed, 5.0, CONTROLS[cell],
                                            device=card)
        assert not correct, readings
