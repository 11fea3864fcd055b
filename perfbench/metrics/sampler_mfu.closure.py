"""The closure batch's step share of the card's FP32 peak over production, %:
the step's FLOPs for every point (``pbench/flops.py``, frozen) x production
steps over the runner's production seconds, against 67 TFLOP/s."""


def read(ctx):
    units = [u for u in ctx["units"] if "production" in u.get("phases", {})]
    if not units:
        return None
    seconds = sum(u["phases"]["production"] for u in units)
    flops = ctx["step_flops"] * ctx["shapes"].points * ctx["n_steps"] * len(units)
    return 100.0 * flops / seconds / ctx["peaks"].PEAK_FP32_FLOPS
