"""Device programs built per analysis: the sampler programs and the fit
programs captured inside the unit's ``fit_emulators`` and ``run_mcmc``
calls (the program's counters ``captures.sampler`` and ``captures.fit``);
0 where every program comes from set-up."""

CAPTURES = ("captures.sampler", "captures.fit")


def read(ctx):
    from pbench import program_spans as ps

    return ps.per_unit(ctx, ["fit_emulators", "run_mcmc"], lambda calls: sum(ps.counter(c, CAPTURES) for c in calls))
