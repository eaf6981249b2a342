"""100 x (1 - the union of device activity over the traced window)."""

def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
