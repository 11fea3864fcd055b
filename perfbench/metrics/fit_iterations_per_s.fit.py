"""L-BFGS iterations per second where the fit runs them: the iterations
replayed by the fit programs (the program's counter ``replays.fit``) over
the seconds of the fit's stages (its ``fit.stage`` spans, each ending with
the device drained), over the window's refits."""


def read(ctx):
    from pbench import program_spans as ps

    calls = ps.window_calls(ctx, "fit_emulators")
    if not calls:
        return None
    seconds = sum(ps.span_seconds(c, ("fit.stage",)) for c in calls.values())
    iterations = sum(ps.counter(c, ("replays.fit",)) for c in calls.values())
    return iterations / seconds if seconds > 0 and iterations else None
