"""edge_idle_ms.prefill: device-idle ms a request while the host is
outside every ``model.prefill`` span: cache allocation, the token copy,
the pick, the synchronise and the loop (``spans.edge_idle_ms``)."""
from portbench import spans


def read(ctx):
    return spans.edge_idle_ms(ctx)
