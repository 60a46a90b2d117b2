"""Attention's share of its roofline, timed by the program's own spans: the
least time a decode step's attention over the INT4 KV cache needs
(``decode_attention`` work), over the device time a step of every graph node
the ``attention.kernel`` span enqueued (the attention kernel, its merge
pass, and what the call runs around them)."""
from portbench import spans

LAYER = "Attention (ops/decode_attention.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
BETTER = "higher"


def read(obs):
    return spans.roofline(obs, "decode_attention", ("attention.kernel",))
