"""Share of the traced window in which no kernel or copy ran on the
device: the window minus the union of the device's event intervals, over
the window.  Read for every ``device_idle_share.<cells>`` metric."""


def read(ctx, out):
    t = out["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)
