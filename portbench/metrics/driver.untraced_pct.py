"""driver.untraced_pct: the share (%) of the window's wall time that no
top-level span of the program names: the window less every call's
top-level spans (``operator``, ``rtr``, ``stats``, ``cert``, ``rank``,
``result``), so the runner's own time between entry and return is in it.
Over the same window, driver.other_pct = operator + rank + result +
stats + untraced."""

from portbench import spans


def read(ctx):
    covered = spans.share(ctx, spans.top_level)
    return None if covered is None else 100.0 - covered
