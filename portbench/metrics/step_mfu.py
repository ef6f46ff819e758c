"""The whole step's share of the card's peak, %: the analytic FLOPs of the
traced stretch's units (`portbench/flops.py`: a train step 3x the forward,
a forecast batch the forward) over its seconds, against the configuration's
peak."""

from portbench.flops import forward_flops, train_step_flops


def read(ctx):
    if ctx.training:
        flops = sum(train_step_flops(ctx.cfg, b) for b in ctx.trace.batches)
    else:
        flops = sum(sum(forward_flops(ctx.cfg, b).values()) for b in ctx.trace.batches)
    return 100.0 * flops / ctx.trace.window_s / ctx.peak
