"""Mean wall of a cold request (full put and Propose, client side) over the
window's cold requests."""


def read(run):
    walls = [r.wall_s for r in run.requests if r.kind == "cold"]
    return sum(walls) / len(walls) if walls else None
