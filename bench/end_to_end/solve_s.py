"""solve_s.<cell kind>: the window over the requests completed in it,
the time to a solution that one closed-loop caller sees."""


def value(run):
    done = len(run["window"].latencies)
    return run["window"].window_s / done if done else None
