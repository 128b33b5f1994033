"""`train_phase_ms.<phase>`: device milliseconds a training step spends in
one of its phases (`forward`, `losses`, `cgt`, `backward`, `update`): the
device busy time from each of the phase's marks `jp_mark_<phase>` to the
next mark, summed over the traced slice's steps, over the steps that an
`end` mark closed (`phases.Phases`; `losses` has two marks a step). None
where the slice has no such mark."""


def read(ctx, metric):
    return ctx.phases.per_unit_ms(metric["name"].split(".", 1)[1])
