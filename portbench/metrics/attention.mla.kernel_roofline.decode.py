"""The latent attention kernel's share of its roofline, timed by the
program's own spans: the least time a decode step's latent attention needs
(``mla_kernel`` work: the larger of its operations, q_lat . c_KV, q_pe .
k_pe and p . c_KV for every head, over 989 TFLOP/s, and its bytes, each
cached position's INT4 codes, planes and k_pe read once with q in and the
output out, over 3.35 TB/s), over the device time a step of every graph
node an ``attention.kernel`` span inside ``attention.mla`` enqueued (K15,
its merge pass, and what the call runs around them). Cells without latent
attention have no such span and read nothing."""
from portbench import mla

LAYER = "Latent attention (ops/mla_attention.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
BETTER = "higher"


def read(obs):
    if obs.driver != "decode" or obs.work is None or "mla_kernel" not in obs.work:
        return None
    ms = mla.span_ms_per_step(obs, "attention.kernel", "attention.mla")
    return 100.0 * obs.work["mla_kernel"].bound_s() * 1e3 / ms if ms else None
