"""Queries answered in the window over the window's seconds."""


def read(run):
    answered = sum(len(s.ids) for s in run.window if s.ids is not None)
    return answered / run.window_s if answered else None
