"""Mean over the window's warm windows of the violations the reference
counts on the soft goals of the placement each warm proposal gives."""


def read(run):
    vals = [r.readings["soft_violations"] for r in run.requests
            if r.kind == "warm" and r.readings is not None]
    return sum(vals) / len(vals) if vals else None
