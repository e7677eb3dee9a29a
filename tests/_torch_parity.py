"""Trajectory parity of the port against the JAX package where a host
decision sits within rounding of its threshold.

Two solves from the same inputs agree to rounding for a while; then a
quantity computed to a finite accuracy (an f32 eigh's escape vectors or
sign count, a LOBPCG run to its residual tolerance, a Rayleigh-Ritz on a
nearly singular Gram) decides something that the other machine's BLAS
decides the other way, and from there the two trajectories differ by more
than rounding.  Tests of such solves hold the trajectory up to that point,
print the margin of the decision, and hold the status, KKT residual and
optimum at the end.
"""

STATS = ("obj", "gap", "pinf", "gradnorm")


def _close(a: float, b: float, rtol: float, atol: float) -> bool:
    return abs(a - b) <= atol + rtol * abs(b)


def parting(ours, ref, rtol: float = 1e-10, atol: float = 1e-14) -> int:
    """The index of the first outer iteration (0-based) where two solve
    histories part: r or p differ, or obj, gap, pinf or gradnorm differ
    by more than ``rtol`` relative (``atol`` absolute, for values at the
    rounding floor); the common length if they never do."""
    for i, (a, b) in enumerate(zip(ours, ref)):
        if a["r"] != b["r"] or a["p"] != b["p"]:
            return i
        if not all(_close(a[k], b[k], rtol, atol) for k in STATS):
            return i
    return min(len(ours), len(ref))


def rel(a: float, b: float) -> float:
    """|a - b| / |b| (0 when both are 0)."""
    return 0.0 if a == b else abs(a - b) / max(abs(b), 1e-300)


def hold(ours, ref, head: int, dinf_rtol: float, rtol: float = 1e-10):
    """The first ``head`` outer iterations agree: ranks exactly, obj, gap,
    pinf and gradnorm to ``rtol``, and the certificate's dinf to
    ``dinf_rtol`` (the accuracy of the certificate that computed it).
    Prints and returns where the histories part."""
    at = parting(ours, ref, rtol)
    print(f"histories part at outer iteration {at + 1} "
          f"(held: the first {head})")
    assert at >= head, f"parted at outer iteration {at + 1} < {head + 1}"
    for a, b in zip(ours[:head], ref[:head]):
        assert _close(a["dinf"], b["dinf"], dinf_rtol, 1e-14), \
            (a["iter"], a["dinf"], b["dinf"])
    return at
