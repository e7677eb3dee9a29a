"""cert.eigh64_pct: the share (%) of the window's wall time in the dense
certificate's exact float64 fallback, the span ``cert.eigh64`` inside
the drivers' ``cert`` (ops/dense_cert.py, DenseEighCert.certify: a
torch.linalg.eigh of the f64 matrix where the refined bound never
certified), each call's timers counted once.  None unless the window's
calls recorded a tier of that certificate (``cert.far`` or
``cert.near``); 0 where they did and the fallback never ran."""

from portbench import spans


def read(ctx):
    timers = spans.recorded(ctx)
    if timers is None or not any("cert.far" in t or "cert.near" in t
                                 for t in timers):
        return None
    return spans.share(ctx, lambda t: t.get("cert.eigh64", 0.0))
