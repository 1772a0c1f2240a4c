"""Device ms a training step in the class "PyTorch elementwise, copies,
reductions" (``work.kernel_class``: neither a GEMM nor a kernel of the
port), from the traced steps. Moves ``train_img_s``."""

from benchmark import work


def read(record):
    trace = record.get("trace")
    if trace is None:
        return None
    ms = sum(s for name, s in trace.device_ops.items()
             if work.kernel_class(name) == work.ELEMENTWISE) * 1e3
    return ms / trace.units
