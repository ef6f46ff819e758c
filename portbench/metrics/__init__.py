"""Per-layer metric readers, found by name: metric `<family>.<kind>` is read
by `<family>.<kind>.py` where that file exists, else by `<family>.py`.

Each holds `read(ctx)`: the metric's value from the traced stretch, or None
where the stretch holds nothing to read it from (the harness then leaves the
metric out of the result line). `ctx` has `trace` (`portbench.trace.Trace`),
`cfg` (the configuration's dict), `training` (whether a unit of the stretch
is a train step or a forecast batch), `families` ({name: kernel family
module}) and `peak` (the product rate of the configuration's compute_dtype,
FLOP/s).
"""


def roofline_share(ctx, family: str):
    """The kernel family's share of its roofline, %: the least seconds its
    work takes (`kernels/<family>.py`, at the configuration's peak) over the
    seconds its kernels ran in the traced stretch; None where none ran."""
    fam = ctx.families[family]
    ran = ctx.trace.kernel_seconds(fam.KERNELS)
    if ran <= 0.0:
        return None
    return 100.0 * fam.bound_s(ctx.cfg, ctx.trace.batches, ctx.training, ctx.peak) / ran
