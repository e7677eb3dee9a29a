"""cert.near_pct: the share (%) of the window's wall time in the dense
certificate's near tier, the span ``cert.near`` inside the drivers'
``cert`` (ops/dense_cert.py, DenseEighCert.certify: the f32 eigh, the
f64 Ogita-Aishima refinement GEMMs and K6), each call's timers counted
once.  None unless the window's calls recorded a tier of that
certificate (``cert.far`` or ``cert.near``)."""

from portbench import spans


def read(ctx):
    timers = spans.recorded(ctx)
    if timers is None or not any("cert.far" in t or "cert.near" in t
                                 for t in timers):
        return None
    return spans.share(ctx, lambda t: t.get("cert.near", 0.0))
