"""A run past the look for a card, on the CPU at tiny sizes: correct when
the program is sound, not correct with the timed path broken underneath
(a step that returns its state unchanged; half of a batch solved and its
answers handed to the other half; an answer altered where it is made)."""

import pytest
import torch

import manisdp_tpu_torch.solvers.batch as batch
import manisdp_tpu_torch.solvers.dual_al as dual_al
from portbench import runner

CPU = torch.device("cpu")
TINY = {"maxcut.torus3k-b16": ({"rows": 6, "cols": 5}, 4),
        "maxcut.g1-b64": ({"n": 40, "m": 120}, 4),
        "bqp-sos.d60": ({"q": 6}, 1)}


def _run(name, options=None):
    traffic, per = TINY[name]
    cell = runner.Cell(name, traffic=traffic)
    cell.traffic["instances_per_call"] = per
    if options:
        cell.config["options"] = dict(cell.config["options"], **options)
    return runner.run(name, 20260101, 0.5, False, device=CPU, cell=cell,
                      log=lambda msg: None)


@pytest.mark.parametrize("name", list(TINY))
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= TINY[name][1] and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"instances_per_s", "setup_s"}


def _frozen(make):
    """make_*trustregions whose solve hands back the point it was given."""
    def wrapped(*a, **kw):
        solve = make(*a, **kw)

        def frozen_solve(Y, *args, **kwargs):
            return solve(Y, *args, **kwargs)._replace(Y=Y)
        return frozen_solve
    return wrapped


def test_step_returning_its_state(monkeypatch):
    monkeypatch.setattr(batch, "make_batched_trustregions",
                        _frozen(batch.make_batched_trustregions))
    out = _run("maxcut.torus3k-b16", {"max_outer": 4})
    assert not out["correct"]
    monkeypatch.setattr(dual_al, "make_trustregions",
                        _frozen(dual_al.make_trustregions))
    out = _run("bqp-sos.d60", {"max_outer": 20})
    assert not out["correct"]


@pytest.mark.parametrize("name", ["maxcut.torus3k-b16", "maxcut.g1-b64"])
def test_half_of_the_batch(monkeypatch, name):
    solve = batch._solve_group

    def half(Cs, ns, *a, **kw):
        k = max(1, len(Cs) // 2)
        out = solve(Cs[:k], ns[:k], *a, **kw)
        return (out * 2)[:len(Cs)]
    monkeypatch.setattr(batch, "_solve_group", half)
    assert not _run(name)["correct"]


def test_answer_altered_where_made(monkeypatch):
    made = batch.SDPResult

    def altered_z(**kw):
        kw["z"] = kw["z"] * (1.0 + 1e-7)
        return made(**kw)
    monkeypatch.setattr(batch, "SDPResult", altered_z)
    assert not _run("maxcut.g1-b64")["correct"]

    def altered_bound(**kw):
        kw["obj"] = kw["obj"] * (1.0 + 1e-7)
        return made(**kw)
    monkeypatch.setattr(dual_al, "SDPResult", altered_bound)
    assert not _run("bqp-sos.d60")["correct"]
