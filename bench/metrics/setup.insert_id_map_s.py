"""Host time of the port's id map during the set-up's inserts: the sum of
the ``id_map`` spans (overwrite check, free-list pops, id-to-slot writes)
of the ``insert_many`` traces that start before the window, in s."""

from benchlib import program


def read(run):
    return program.setup_stage_s(run, "insert_many", ("id_map",),
                                 device=False)
