"""Device: the share of the traced window in which no operation ran on
the card (1 - the union of the device operations' intervals over the
window's length), in %."""

from benchmark.harness.trace import busy_us


def read(run):
    d = run["trace"]
    if d is None or not d.device_ops or d.window_us <= 0:
        return None
    return 100.0 * (1.0 - busy_us(d) / d.window_us)
