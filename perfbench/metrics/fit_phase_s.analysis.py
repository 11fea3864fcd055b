"""Mean seconds of an analysis' ``fit_emulators`` call (host PCA and the GP
fit of every PC, drained), on the host clock."""


def read(ctx):
    fits = [u["fit_s"] for u in ctx["units"] if "fit_s" in u]
    return sum(fits) / len(fits) if fits else None
