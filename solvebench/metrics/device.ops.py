"""``device.ops`` (ops/solve; layer device; device trace): the device
operations (kernels, copies, fills) in one solve profiled with the card's
activity only."""

UNIT = "ops/solve"


def read(run):
    p = run.device_profile
    return None if p is None or p.count == 0 else float(p.count)
