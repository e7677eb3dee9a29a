"""Every roofline's byte count against a count by hand at one shape."""

from portbench import registry, timing


def test_k11_bytes():
    m = registry.metric("k11_roofline")
    B, p, n = 16, 48, 3072
    L = B * p * n
    # reads d, Hd, eta, Heta, r, Y; writes eta, Heta, r, d; (B, 8) f64
    # scalars in and out; (B, 2) int32 state in and out
    hand = 10 * L * 8 + 2 * (B * 8 * 8) + 2 * (B * 2 * 4)
    assert m.bytes_at(B, p, n) == hand == 188_743_680 + 2_304


def test_k1_instance_bytes():
    m = registry.metric("k1_instance_roofline")
    B, p, n, nnz = 16, 48, 3072, 16 * 15_000
    # A, B in and the output (B, p, n) f64; eG (B, n) f64; values f64
    # and rows int32 per entry; (B, n + 1) int32 pointers; (B,) int64
    hand = 3 * B * p * n * 8 + B * n * 8 + nnz * 8 + nnz * 4 + \
        B * (n + 1) * 4 + B * 8
    assert m.bytes_at(B, p, n, nnz) == hand


def test_k7_k8_bytes():
    q = 60
    n = 2 + q + q * q                       # 3,662
    flat = 1 + q + q ** 2 + q ** 3 + q ** 4  # 13,179,661
    assert n == 3662 and flat == 13_179_661
    assert registry.metric("k7_roofline").bytes_at(q) == \
        (n * n + flat) * 4
    assert registry.metric("k8_roofline").bytes_at(q) == \
        (flat + 5 + n * n) * 4
    # PERF.md's table: K7's bound at q = 60 in f32 is 0.0317 ms
    assert abs(timing.bound_ms((n * n + flat) * 4, 0.0, "float32")
               - 0.0317) < 5e-4


def test_bound_takes_the_larger():
    assert timing.bound_ms(3.35e12, 0.0, "float64") == 1e3
    assert timing.bound_ms(0.0, 34e12, "float64") == 1e3
    assert timing.bound_ms(3.35e9, 67e12, "float32") == 1e3
