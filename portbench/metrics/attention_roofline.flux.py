"""K3's work a step at head dim 128 (the 57 joint attentions over 2,912
tokens, 4 B H S^2 d FLOPs each, by portbench/work/flux.py) at the bf16
peak, over the device time of the kernels launched inside the program's
`attn.kernel` spans, in %."""

from portbench import spanread
from portbench.tracekit import PEAK_BF16_FLOPS


def read(trace):
    ms = spanread.device_ms(trace, "attn.kernel")
    flops = trace.work.get("k3_flops")
    if not ms or not flops:
        return None
    return 100.0 * flops / PEAK_BF16_FLOPS / (ms / 1e3)
