"""Instances repeat by (seed, call), never repeat within a run, and every
seed gets the same sizes."""

import numpy as np
import pytest
import scipy.sparse as sp

from portbench import registry, runner

CELLS = [c["name"] for c in registry.benchmark()["workloads"]]


def _key(inst):
    if sp.issparse(inst):
        return ("C", inst.shape, inst.nnz,
                np.round(inst.toarray(), 12).tobytes())
    Q, e, q = inst
    return ("bqp", q, Q.tobytes(), e.tobytes())


def _sizes(inst):
    if sp.issparse(inst):
        # edges; the diagonal holds a zero where +-1 weights cancel
        return inst.shape, sp.triu(inst, 1).nnz
    return inst[2], inst[0].shape


@pytest.mark.parametrize("name", CELLS)
def test_instances_repeat_by_seed_and_call(name):
    cell = runner.Cell(name)
    seed = 2 ** 31 + 12345
    a = cell.instances(seed, runner.STREAM_WINDOW, 3)
    b = cell.instances(seed, runner.STREAM_WINDOW, 3)
    assert [_key(x) for x in a] == [_key(x) for x in b]
    assert len(a) == cell.traffic["instances_per_call"]


@pytest.mark.parametrize("name", CELLS)
def test_no_instance_repeats_within_a_run(name):
    cell = runner.Cell(name)
    seen = set()
    for stream, calls in ((runner.STREAM_WARM, 1), (runner.STREAM_WINDOW, 3),
                          (runner.STREAM_TRACE, 2)):
        for k in range(calls):
            for inst in cell.instances(-77, stream, k):
                key = _key(inst)
                assert key not in seen
                seen.add(key)


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_gets_the_same_sizes(name):
    cell = runner.Cell(name)
    sizes = {tuple(_sizes(x) for x in cell.instances(s, 0, 0))
             for s in (0, 1, 2 ** 40 + 3)}
    assert len(sizes) == 1


def test_published_shapes():
    torus = registry.generator("torus_pm1").make(
        {"rows": 60, "cols": 50}, np.random.default_rng(5))
    assert torus.shape == (3000, 3000)
    W = sp.triu(torus, 1)
    assert W.nnz == 6000 and set(np.unique(-4.0 * W.data)) <= {-1.0, 1.0}
    g1 = runner.Cell("maxcut.g1-b64").instances(5, 0, 0)[0]
    assert g1.shape == (800, 800) and sp.triu(g1, 1).nnz == 19176
    Q, e, q = runner.Cell("bqp-sos.d60").instances(5, 0, 0)[0]
    assert q == 60 and np.array_equal(Q, Q.T) and e.shape == (60,)


@pytest.mark.parametrize("name", CELLS)
def test_seeds_vary_the_same_pool(name):
    """Every seed gets the pool's problems in its own variant: a G1-size
    graph renumbered (the same spectrum), a torus cost shifted by a I
    (the same off-diagonal), a BQP scaled by a power of two."""
    cell = runner.Cell(name)
    one, two = cell.instances(1, 0, 0), cell.instances(2, 0, 0)
    assert [_key(x) for x in one] != [_key(x) for x in two]
    a, b = next((x, y) for x, y in zip(one, two) if _key(x) != _key(y))
    if cell.traffic["generator"] == "torus_pm1":
        base = registry.generator("torus_pm1").make(
            cell.traffic["params"],
            runner.pool_rng(cell.traffic["pool_entropy"], 0,
                            cell.traffic["first_call"], 0))
        d = (one[0] - base).toarray()
        assert np.array_equal(d, d[0, 0] * np.eye(base.shape[0]))
        assert -1.0 / 16 <= d[0, 0] <= -1.0 / 1024
        assert (d[0, 0] * 1024).is_integer()
    elif sp.issparse(a):
        wa = np.linalg.eigvalsh(a.toarray())
        wb = np.linalg.eigvalsh(b.toarray())
        assert np.allclose(wa, wb, atol=1e-9)
    else:
        c = b[0][0, 1] / a[0][0, 1]
        assert c in [2.0 ** k for k in range(-3, 4)]
        assert np.array_equal(b[0], c * a[0]) and np.array_equal(b[1], c * a[1])


def test_first_call_offsets_the_window():
    """The stall mix sends the torus mix's pool from its call 16 in the
    window, and the same warm-up and traced calls."""
    plain = runner.Cell("maxcut.torus3k-b16")
    stall = runner.Cell("maxcut.torus3k-b16-stall")
    seed = 2 ** 33 + 1
    for k in (0, 4):
        assert [_key(x) for x in plain.instances(seed, runner.STREAM_WINDOW,
                                                 16 + k)] == \
            [_key(x) for x in stall.instances(seed, runner.STREAM_WINDOW, k)]
    for stream in (runner.STREAM_WARM, runner.STREAM_TRACE):
        assert [_key(x) for x in plain.instances(seed, stream, 0)] == \
            [_key(x) for x in stall.instances(seed, stream, 0)]
