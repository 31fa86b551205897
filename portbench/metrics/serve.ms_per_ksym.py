"""Host milliseconds the node's ``SymbolStream.frames`` took per 1,000
symbols it served in the traced window (a span the benchmark wraps
around the call)."""


def read(run):
    if run.spans is None:
        return None
    served = run.spans.counts.get("serve", 0)
    if not served:
        return None
    return run.spans.seconds("serve") * 1e3 / (served / 1000)
