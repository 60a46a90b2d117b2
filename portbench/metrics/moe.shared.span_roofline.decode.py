"""The shared experts as a share of their roofline, timed by the program's
own spans: the least time a decode step's shared experts need (``shared_
expert`` work: the INT4 gate, up and down weights of every MoE layer's
shared expert and each row in and out once), over the device time a step
of every graph node the ``moe.shared`` span enqueued, its ``linear``
children's included (the three linears and the SwiGLU between them). Cells
without a shared expert have no such span and read nothing."""
from portbench import span_tree

LAYER = "Linears (ops/int4_matmul.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
BETTER = "higher"


def read(obs):
    return span_tree.roofline(obs, "shared_expert", "moe.shared")
