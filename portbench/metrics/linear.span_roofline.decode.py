"""The linears' share of their roofline, timed by the program's own spans:
the least time a decode step's attention projections, routers and lm_head
need (``int4_matmul`` work: packed weights and scales, x in, y out), over
the device time a step of every graph node that the ``linear`` span and its
``linear.dense`` child (dequantize, then cuBLAS, above K1's row threshold)
enqueued. It reads whatever path the linears take, so a cell whose linears
run no K1 has it too."""
from portbench import spans

LAYER = "Linears (ops/int4_matmul.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
BETTER = "higher"


def read(obs):
    return spans.roofline(obs, "int4_matmul", ("linear", "linear.dense"))
