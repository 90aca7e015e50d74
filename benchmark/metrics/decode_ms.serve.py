"""The test loader's own work a volume (decode, transforms, collation):
the program's ``test_loader_produce`` counter, seconds over items, read in
the process from ``fpl_plus_torch.utils.trace_metrics`` after the run, as
the harness reads the kernel's launch counter (ms). It covers the run's
warm-up calls and its window; the producer is a thread the profiler does
not record. None where the program has no counter table or no such
count."""


def read(ctx):
    if ctx.trace is None or ctx.stage != 'test':
        return None
    from fpl_plus_torch.utils import trace_metrics
    counters = getattr(trace_metrics, 'counters', None)
    if counters is None:
        return None
    calls, seconds = counters().get('test_loader_produce', (0, 0.0))
    return 1e3 * seconds / calls if calls else None
