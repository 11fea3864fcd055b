"""Mean seconds per analysis of the runner's host work: ``run_mcmc``'s span
less its burn-in phases (``burn.phase1``, ``burn.phase2``) and its
production chunks (``chunk``), each of which ends with the device drained;
what is left is the likelihood build, the programs' lookup, the resample and
the downloads, the statistics and the write (the program's spans)."""

DEVICE_SPANS = ("burn.phase1", "burn.phase2", "chunk")


def read(ctx):
    from pbench import program_spans as ps

    return ps.per_unit(ctx, ["run_mcmc"], lambda calls: ps.seconds(calls[0]) - ps.span_seconds(calls[0], DEVICE_SPANS))
