"""Device ms an item: the card's busy time (the union of its kernels'
intervals) over the traced segment, over the segment's items. Each item
runs one eager solve (the program's warm-up for the new hierarchy) and
its capture; the layouts' copies and kernels count too."""


def read(run):
    t, seg = run.trace, run.segment
    if t is None or not seg.get("items") or t.busy_s <= 0:
        return None
    return 1e3 * t.busy_s / seg["items"]
