"""Production point-steps per second of the window's closure batches: points
x production steps over the runner's production seconds."""


def read(ctx):
    units = [u for u in ctx["units"] if "production" in u.get("phases", {})]
    if not units:
        return None
    return ctx["shapes"].points * ctx["n_steps"] * len(units) / sum(u["phases"]["production"] for u in units)
