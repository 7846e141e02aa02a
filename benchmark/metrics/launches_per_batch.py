"""Launch path: device operations (kernels, copies, sets) in the traced
window of torch.profiler, over the batches dispatched in it."""


def read(run):
    d = run["trace"]
    if d is None or not d.device_ops or d.batches < 1:
        return None
    return len(d.device_ops) / d.batches
