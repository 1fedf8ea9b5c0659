"""device_idle_frac: 1 - (the union of the kernels' intervals) / (the
traced window's host-clock span), the window opened after a synchronize
and closed by one, so stalls at its edges count."""
from cadbench.frozen.trace import busy_us


def read(rec):
    if not rec.kernels or rec.window_s <= 0:
        return None
    return 1.0 - busy_us(rec.kernels) / 1e6 / rec.window_s
