"""device.idle_share: 1 minus the union of the device's kernel, copy and set
intervals over the traced stretch's wall."""

from benchmark.harness.trace import device_busy_us


def read(ctx):
    busy = device_busy_us(ctx.stretch)
    if busy <= 0:
        return None
    return 1.0 - busy / ctx.stretch.wall_us
