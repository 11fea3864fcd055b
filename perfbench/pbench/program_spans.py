"""The program's own spans and counters, for the per-layer metrics that read
them: the history of root calls that the port's recorder keeps in memory
(``utils/profiling.history()``: each root call with its name, its spans on
the ``time.perf_counter_ns`` clock, each with its parent, and its counters).

The recorder is read where the harness has loaded it (``sys.modules``): this
module imports nothing of the port, so ``pbench/program.py`` stays the
harness's one importer of it. Where the program has no recorder, or its
history cannot be read, every function here returns None; none raises.

A unit's root calls are found by their order: of the root calls named
``name``, the last ``units[-1]["index"] + 1`` are the window's, unit 0 first,
and a reader takes those of the units the context reads (``ctx["units"]``,
as the host-clock readers do).
"""

from __future__ import annotations

import sys

RECORDER = "bayesian_inference_tpu_torch.utils.profiling"


def history() -> list[dict] | None:
    """The recorder's finished root calls, oldest first, or None."""
    read = getattr(sys.modules.get(RECORDER), "history", None)
    if not callable(read):
        return None
    try:
        calls = read()
    except Exception:  # noqa: BLE001 -- a recorder that fails reads as none
        return None
    return calls if isinstance(calls, list) else None


def window_calls(ctx: dict, name: str) -> dict[int, dict] | None:
    """{unit index: its root call named ``name``} for each unit of the
    context, or None."""
    calls, units = history(), ctx.get("units") or []
    if not calls or not units:
        return None
    named = [c for c in calls if c.get("name") == name]
    n = int(units[-1]["index"]) + 1
    if len(named) < n:
        return None
    window = named[-n:]
    return {int(u["index"]): window[int(u["index"])] for u in units}


def seconds(call: dict) -> float:
    """The root call's own seconds."""
    return (call["end_ns"] - call["start_ns"]) / 1e9


def span_seconds(call: dict, names) -> float:
    """Seconds of the root call's spans named in ``names``, summed."""
    return sum(s["end_ns"] - s["start_ns"] for s in call["spans"][1:] if s["name"] in names) / 1e9


def counter(call: dict, names) -> int:
    """The root call's counters named in ``names``, summed."""
    return sum(int(call["counters"].get(n, 0)) for n in names)


def per_unit(ctx: dict, names, value) -> float | None:
    """The mean over the context's units of ``value(calls)``, where
    ``calls`` are the unit's root calls of every name in ``names``; None
    where a unit lacks one."""
    found = [window_calls(ctx, name) for name in names]
    if any(f is None for f in found):
        return None
    units = [int(u["index"]) for u in ctx["units"]]
    return sum(value([f[i] for f in found]) for i in units) / len(units)
