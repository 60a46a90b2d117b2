"""Attention's share of its roofline: the least time a decode step's
attention needs (the INT4 K/V codes and their scale planes up to each row's
length, q in and out once), over the attention kernels' device time per
step in the trace (``ops/decode_attention.py``: main kernel and merge)."""
from portbench import trace

LAYER = "Attention (ops/decode_attention.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
BETTER = "higher"


def _main(name):
    return "int4_attention" in name and "merge" not in name


def read(obs):
    if obs.driver != "decode" or obs.trace is None or obs.work is None:
        return None
    ms = trace.family_ms(obs.trace.kernels(), _main) / obs.steps_traced
    return 100.0 * obs.work["decode_attention"].bound_s() * 1e3 / ms if ms else None
