"""Share of the rows left to a slice minimum (``table.slice_rows``) that
the ``lf_walk`` kernel walked (``table.lf_kernel_rows``), in percent: 100
where a frozen table's walks run on the card's kernel.  None from a
program without the counter, or where no row was walked."""


def read(ctx):
    if "table.lf_kernel_rows" not in ctx.counters:
        return None
    walked = ctx.counters["table.lf_kernel_rows"][0]
    rows = ctx.counters.get("table.slice_rows", (0.0, 0))[0]
    return 100.0 * walked / rows if rows else None
