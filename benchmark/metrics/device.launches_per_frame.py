"""device.launches_per_frame: device kernels in the traced window over its
loop steps (a step of the batched runner is one frame of every
instance). A count: it repeats exactly on one program."""


def read(rec):
    t = rec["trace"]
    if t is None or not t.steps or not t.kernels:
        return None
    return len(t.kernels) / t.steps
