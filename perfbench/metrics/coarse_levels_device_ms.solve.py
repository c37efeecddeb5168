"""Device ms a solve on every level below the finest: the span
`mg.level1`, inclusive of the deeper levels and the coarsest Chebyshev
solve, read from the port's span registry, over the `pcg` span's device
calls."""


def read(run):
    from gnnla_tpu_torch.utils import program
    report = getattr(program, "report", None)
    if report is None:
        return None
    spans = report()
    pcg, level = spans.get("pcg"), spans.get("mg.level1")
    if not pcg or not pcg["device_calls"] or not level or \
            not level["device_calls"]:
        return None
    return 1e3 * level["device_s"] / pcg["device_calls"]
