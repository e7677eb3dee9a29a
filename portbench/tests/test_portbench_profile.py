"""The trace arithmetic: busy time as a union, idle gaps, and each gap
put on the innermost host op over it."""

from portbench import profile


def test_union_counts_overlaps_once():
    assert profile.union_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    assert profile.union_us([]) == 0


def test_gaps_and_their_host_ops():
    dev = [(10, 20), (40, 50), (51, 60)]
    g = profile.gaps(dev, 0, 100, min_len=5)
    assert g == [(0, 10), (20, 40), (60, 100)]        # 50..51 too short
    host = [(0, 100, "call"), (15, 45, "aten::mm"), (25, 35, "cudaMemcpy")]
    got = profile.attribute(g, host)
    # (0, 10): mid 5 -> call; (20, 40): mid 30 -> the innermost,
    # cudaMemcpy; (60, 100): mid 80 -> call
    assert got == {"call": 50e-6, "cudaMemcpy": 20e-6}
    assert profile.attribute([(0, 4)], []) == {profile.NO_OP: 4e-6}
    assert profile.top({"a": 1.0, "b": 3.0, "c": 2.0}, k=2) == \
        [["b", 3.0], ["c", 2.0]]


def test_kinds():
    assert profile.kind_of("void tcg_step_kernel<double>(...)") == \
        "K11 tcg_step"
    assert profile.kind_of("syevd_kernel") == "cuSOLVER"
    assert profile.kind_of("something_new") == "other"
