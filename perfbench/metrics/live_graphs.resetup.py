"""The graphs the shared solve program holds after the traced segment
(`Program.live`, read by the driver before it drops the program): one for
the hierarchy in use, where a program releases the graphs of hierarchies
its caller has dropped. None where the program counts no live graphs."""


def read(run):
    return run.info.get("live_graphs")
