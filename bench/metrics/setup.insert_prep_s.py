"""Host time to prepare the set-up's inserts: the sum of the ``prep``
spans (ids to a list, rows padded on the card, repeated ids dropped) of
the ``insert_many`` traces that start before the window, in s."""

from benchlib import program


def read(run):
    return program.setup_stage_s(run, "insert_many", ("prep",), device=False)
