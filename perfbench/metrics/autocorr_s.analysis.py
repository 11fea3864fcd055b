"""Mean seconds of an analysis' chain statistics (tau and split R-hat),
``run_mcmc``'s ``autocorr`` timing."""


def read(ctx):
    t = [u["phases"]["autocorr"] for u in ctx["units"] if "autocorr" in u.get("phases", {})]
    return sum(t) / len(t) if t else None
