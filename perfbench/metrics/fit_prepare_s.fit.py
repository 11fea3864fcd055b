"""Mean seconds per refit of the host's preparation of every group: the
``fit.prepare`` spans of ``fit_emulators`` (the group's prediction matrix
and its PCA, on the host), summed."""


def read(ctx):
    from pbench import program_spans as ps

    return ps.per_unit(ctx, ["fit_emulators"], lambda calls: ps.span_seconds(calls[0], ("fit.prepare",)))
