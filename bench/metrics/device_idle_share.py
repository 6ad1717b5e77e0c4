"""device_idle_share.<cell kind>: the share of the traced window (from
the first traced request span's start to the last one's end) in which no
operation ran on the card."""


def value(trace, run, ctx):
    w = trace.window_s
    return 100.0 * (1.0 - trace.busy_s / w) if w > 0 else None
