"""The fit's share of the card's FP32 peak, %: the FLOPs of one fit of every
PC with its restarts (``pbench/flops.py``, frozen) over the mean seconds of a
``fit_emulators`` call, against 67 TFLOP/s."""


def read(ctx):
    fits = [u["fit_s"] for u in ctx["units"] if "fit_s" in u]
    if not fits:
        return None
    return 100.0 * ctx["fit_flops"] / (sum(fits) / len(fits)) / ctx["peaks"].PEAK_FP32_FLOPS
