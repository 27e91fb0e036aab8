"""Share of the traced stretch in which no operation ran on the card
(one less the union of the device intervals over its length), in
percent: ``device.idle_share`` of the writing cells, which report
``queries_per_s.append``."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s else None
