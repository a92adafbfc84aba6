"""device_idle_pct (%, layer "device"): the share of the window in which
no kernel, copy or fill ran on the device (one minus the union of their
intervals over the window)."""


def read(view):
    if view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
