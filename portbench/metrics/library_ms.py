"""Device ms a unit (a train step, or a forecast batch) of every kernel that
is not one of the port's own (the kernel families' names): ATen, cuBLAS and
cuFFT work of the model, the optimizer and the engine."""


def read(ctx):
    port = [fam.KERNELS for fam in ctx.families.values()]
    return 1e3 * ctx.trace.kernel_seconds(exclude=port) / ctx.trace.units
