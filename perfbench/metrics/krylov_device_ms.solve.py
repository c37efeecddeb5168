"""Device ms a solve in CG's own work: the span `pcg` less its `mg.cycle`
spans (the fine A p, the dot products, the vector updates), read from the
port's span registry (`gnnla_tpu_torch/utils/program.py`) after the
traced replays, over the `pcg` span's device calls (one a replay)."""


def read(run):
    from gnnla_tpu_torch.utils import program
    report = getattr(program, "report", None)
    if report is None:
        return None
    pcg = report().get("pcg")
    if not pcg or not pcg["device_calls"]:
        return None
    return 1e3 * pcg["self_device_s"] / pcg["device_calls"]
