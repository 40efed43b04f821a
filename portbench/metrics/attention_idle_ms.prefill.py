"""attention_idle_ms.prefill: device-idle ms a request while the host
is inside the program's ``layer.attention`` spans (``spans.idle_ms``)."""
from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "layer.attention")
