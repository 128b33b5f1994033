"""`replay_idle_ms.<entry>`: device idle milliseconds inside a unit (a
training step, an eval forward), a unit of the traced slice: from the
mark that opens the unit to the end of its `end` mark, the time in which
no device operation ran (`phases.Phases.idle_ms`). The idle between
units (inputs, read-backs, the host's own work) is not in it. None where
the slice has no marks."""


def read(ctx, metric):
    return ctx.phases.idle_ms()
