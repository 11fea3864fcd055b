"""Nodes of the sampler's step graph that run on the card (kernels, copies,
sets), as the program counted them through libcuda at its newest capture
(its counters ``graph_nodes.sampler.<type>``; the analyses' programs are
captured in set-up)."""

KINDS = ("kernel", "memcpy", "memset")


def read(ctx):
    from pbench import program_spans as ps

    for call in reversed(ps.history() or []):
        counters = call.get("counters", {})
        if any(k.startswith("graph_nodes.sampler.") for k in counters):
            return sum(int(counters.get(f"graph_nodes.sampler.{k}", 0)) for k in KINDS)
    return None
