"""Share of its roofline the ``bounded_search`` kernel reaches over the
traced stretch: the least time of its launches (``roofline.
search_traffic`` on each launch's own patterns) over their device
time, in percent."""


def read(ctx):
    return ctx.roofline.kernel_share(ctx, "bounded_search",
                                     ctx.roofline.search_traffic)
