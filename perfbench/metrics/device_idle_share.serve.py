"""Device, serving window: the share of the traced part of the window in
which no operation ran on the card (one minus the union of the device
operations' intervals), in percent."""


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "serve" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
