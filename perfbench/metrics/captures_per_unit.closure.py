"""Device programs built per closure batch, inside its ``run_closure_batch``
call (the program's counters ``captures.sampler`` and ``captures.fit``): the
phase-2 burn-in program, built in every batch, is one."""

CAPTURES = ("captures.sampler", "captures.fit")


def read(ctx):
    from pbench import program_spans as ps

    return ps.per_unit(ctx, ["run_closure_batch"], lambda calls: ps.counter(calls[0], CAPTURES))
