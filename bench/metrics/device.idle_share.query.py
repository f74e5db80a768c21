"""Share of the unstaged steps' time in which nothing ran on the card
(the union of device-activity intervals under ``torch.profiler``)."""


def read(run):
    if run.timeline is None:
        return None
    idle = run.timeline.idle_share()
    return None if idle is None else 100.0 * idle
