"""Device ms a solve at the finest level alone: the self time of the
span `mg.level0` (its Jacobi sweeps, residual, P^T and P, less level 1's
span), read from the port's span registry, over the `pcg` span's device
calls."""


def read(run):
    from gnnla_tpu_torch.utils import program
    report = getattr(program, "report", None)
    if report is None:
        return None
    spans = report()
    pcg, level = spans.get("pcg"), spans.get("mg.level0")
    if not pcg or not pcg["device_calls"] or not level or \
            not level["device_calls"]:
        return None
    return 1e3 * level["self_device_s"] / pcg["device_calls"]
