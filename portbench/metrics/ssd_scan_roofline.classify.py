"""The SSD scan's share of its roofline: the bounds of the traced
invocations' prefill scans (``work_hybrid.ssd_call``: one a Mamba2 layer
over the prefill's B x S padded positions, the chunked dual form's
operations; x, dt, B and C in, y and the final state out once) over the
device time of the kernels whose names hold ``ssd_scan``. None where the
configuration has no Mamba2 layer."""

from portbench import readers, work_hybrid

NAMES = ("ssd_scan",)


def calls(hm, r):
    c = work_hybrid.ssd_call(hm, r.batch, r.padded_len)
    for _ in range(hm.mamba_layers):
        yield c


def read(ctx):
    if "layer_types" not in ctx.spec.config:
        return None
    hm = work_hybrid.dims(ctx.spec.config)
    return readers.roofline(ctx, NAMES, lambda r: calls(hm, r))
