"""attention_ms.prefill: device ms a request of the kernels launched
inside the program's ``layer.attention`` spans (``spans.device_ms``)."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "layer.attention")
