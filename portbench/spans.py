"""The program's per-call spans as shares of the window: what the span
readers under metrics/ have in common.

Each solver call's ``timers`` (``SDPResult.timers``, recorded by
manisdp_tpu_torch/utils/timers.py) holds seconds per span.  A name
without a dot is a top-level span, and a call's top-level spans follow
one another from its entry to its return: ``operator``, per outer
iteration ``rtr``, ``stats`` (the dual), ``cert`` and ``rank``, then
``result``.  A dotted name lies inside the span its prefix names
(``rtr.wait``) or is a derived value (``batch.held``).  A program whose
calls record only some phases has no ``result`` span, and every reader
here returns None for it."""


def recorded(ctx):
    """Each window call's timers once, or None unless every call was
    recorded from entry to return."""
    timers = ctx.timers()
    if not timers or any("result" not in t for t in timers):
        return None
    return timers


def top_level(t: dict) -> float:
    """Seconds in a call's top-level spans."""
    return sum(v for k, v in t.items() if "." not in k)


def share(ctx, part):
    """100 x the window's sum of ``part(timers)`` over the window's wall
    time, or None (see ``recorded``)."""
    timers = recorded(ctx)
    if timers is None:
        return None
    return 100.0 * sum(part(t) for t in timers) / ctx.window_s
