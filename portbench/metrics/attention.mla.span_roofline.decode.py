"""Latent attention as a whole as a share of its roofline, timed by the
program's own spans: the least time a decode step's ``attention.mla`` spans
need (``mla_span`` work: the q_a, q_b, kv_a and o projections, the
absorption of W_UK and W_UV, the latent attention kernel and the new
position written to the latent cache), over the device time a step of
every graph node enqueued inside ``attention.mla``, its children's
included (their ``linear`` spans, ``attention.rope``,
``attention.kv_append``, ``attention.mla.absorb`` and ``attention.kernel``).
Cells without latent attention have no such span and read nothing."""
from portbench import span_tree

LAYER = "Latent attention (ops/mla_attention.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
BETTER = "higher"


def read(obs):
    return span_tree.roofline(obs, "mla_span", "attention.mla")
