"""Production steps per second of the window's analyses: every unit's
production steps over the runner's production seconds (``run_mcmc``'s
``timings``, each phase drained by its download)."""


def read(ctx):
    units = [u for u in ctx["units"] if "production" in u.get("phases", {})]
    if not units:
        return None
    return ctx["n_steps"] * len(units) / sum(u["phases"]["production"] for u in units)
