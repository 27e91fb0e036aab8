"""Share of its roofline the ``tier_scan`` kernel reaches over the traced
stretch: the least time of its launches (``roofline.tier_traffic`` on
each launch's own patterns and tiers) over their device time, in
percent."""


def read(ctx):
    return ctx.roofline.kernel_share(ctx, "tier_scan",
                                     ctx.roofline.tier_traffic)
