"""Readers of the port's host spans (``repro_torch.spans``): each metric
divides span totals by a span count from the same totals, so a window
traced twice reads as one. A program without spans reads nothing."""


def totals(r):
    """The port's span totals, or None: a window with no request, or a
    program that has no spans."""
    if not r.records:
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.totals()


def per_call(r, names, per, field="self_ns", scale=1e-6):
    """The summed ``field`` of the spans ``names`` (times ``scale``) over
    the calls of the span ``per``; None where ``per`` never ran."""
    t = totals(r)
    calls = (t or {}).get(per, {}).get("calls", 0)
    if not calls:
        return None
    return sum(t.get(n, {}).get(field, 0) for n in names) * scale / calls
