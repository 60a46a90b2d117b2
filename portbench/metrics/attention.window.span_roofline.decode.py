"""The window layers' attention as a share of its roofline, timed by the
program's own spans: the least time a decode step's window layers need to
read their INT4 KV rings (``window_attention`` work: every slot of each
ring, q in and out once), over the device time a step of every graph node
enqueued inside the ``attention.window`` span (its ``attention.kernel``
child: the K3 calls over the rings and what runs around them). Cells
without window layers have no such span and read nothing."""
from portbench import span_tree

LAYER = "Attention (ops/decode_attention.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
BETTER = "higher"


def read(obs):
    return span_tree.roofline(obs, "window_attention", "attention.window")
