"""Kernels: ``csrc/clip_tb.cu`` (the clip traceback). The device time of
the kernels under the traced ``urmap::clip_tb`` calls, over the batches
dispatched in the traced window, in ms; None where no such call was
traced (a program without the operator, or a window without clip-mode
gapped winners)."""


def read(run):
    d = run["trace"]
    if d is None or d.batches < 1:
        return None
    us = [us for op in d.ops if op["name"] == "urmap::clip_tb"
          for _, us in op["kernels"]]
    return sum(us) / 1e3 / d.batches if us else None
