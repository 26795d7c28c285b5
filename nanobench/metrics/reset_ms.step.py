"""Mean wall ms of the vector env's day-end reset (fresh days for every env,
the BESS carried), from the benchmark's span around the env's public
``reset`` during the untraced steps."""


def read(ro):
    times = [dt for t0, dt in ro.work["resets"] if any(u.start <= t0 <= u.end for u in ro.units)]
    return 1e3 * sum(times) / len(times) if times else None
