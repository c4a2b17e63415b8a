"""The card's idle share of the traced window: 100 x (1 - busy / window).
Every cell's `device_idle.<cell kind>` reads it."""


def read(ctx):
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
