"""Device programs built per refit, inside its ``fit_emulators`` call (the
program's counters ``captures.fit`` and ``captures.sampler``); 0 where the
fit programs of set-up serve every stage."""

CAPTURES = ("captures.sampler", "captures.fit")


def read(ctx):
    from pbench import program_spans as ps

    return ps.per_unit(ctx, ["fit_emulators"], lambda calls: ps.counter(calls[0], CAPTURES))
