"""Mean seconds per closure batch of the runner's host work:
``run_closure_batch``'s span less its burn-in phases (``burn.phase1``,
``burn.phase2``) and its production chunks (``chunk``), each of which ends
with the device drained; what is left is the build (pseudodata, likelihood,
offsets), the programs' lookup, the resample, the phase-2 program captured
in every batch (``burn.capture``), the downloads, the statistics and the
outputs (the program's spans)."""

DEVICE_SPANS = ("burn.phase1", "burn.phase2", "chunk")


def read(ctx):
    from pbench import program_spans as ps

    return ps.per_unit(ctx, ["run_closure_batch"],
                       lambda calls: ps.seconds(calls[0]) - ps.span_seconds(calls[0], DEVICE_SPANS))
