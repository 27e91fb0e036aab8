"""Share of its roofline the ``fm_scan`` kernel reaches over the traced
stretch: the least time of its launches (``roofline.fm_traffic`` on
each launch's own patterns) over their device time, in percent."""


def read(ctx):
    return ctx.roofline.kernel_share(ctx, "fm_scan",
                                     ctx.roofline.fm_traffic)
