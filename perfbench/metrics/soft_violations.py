"""Mean over the window's cold proposals of the violations the reference
counts on the soft goals of the placement the proposal gives."""


def read(run):
    vals = [r.readings["soft_violations"] for r in run.requests
            if r.kind == "cold" and r.readings is not None]
    return sum(vals) / len(vals) if vals else None
