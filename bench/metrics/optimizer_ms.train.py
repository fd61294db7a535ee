"""Optimizer: device time of the operations launched inside the
harness's ``bench.optimizer`` span around ``Trainer._opt_fn`` (matched by
the runtime's launch correlation), per profiled step, in ms."""


def read(r):
    if r.trace is None or not r.values.get("profiled_steps"):
        return None
    spans = len(r.trace.spans("bench.optimizer"))
    if not spans:
        return None
    return 1e3 * r.trace.span_device_seconds("bench.optimizer") / spans
