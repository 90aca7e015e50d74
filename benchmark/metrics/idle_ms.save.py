"""The card idle while the test stage's host saved a label: the slice's
idle gaps named ``save_outputs``, ``save_geometry_read`` or
``save_nifti_write`` by launch correlation (``harness/stall.py``), per
volume (ms). None where the program has no ``save_outputs`` span."""
from benchmark.harness.stall import has_host_span, idle_ms


def read(ctx):
    t = ctx.trace
    if t is None or ctx.stage != 'test' \
            or not has_host_span(t, 'save_outputs'):
        return None
    return idle_ms(t, ['save_outputs', 'save_geometry_read',
                       'save_nifti_write'])
