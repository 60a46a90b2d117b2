"""The whole decode step's share of the card's peak: the least time its work
needs (the larger of its operations over 989 TFLOP/s and the bytes it must
move over 3.35 TB/s: every weight of the linears, the experts the routing
hit, the KV cache up to each row's length, activations in and out, the new
K/V written), over the step's device time (CUDA events around a replay,
over its steps)."""
LAYER = "Model (models/transformer.py, layers/)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
BETTER = "higher"


def read(obs):
    if obs.driver != "decode" or obs.work is None or not obs.device_ms_per_step:
        return None
    return 100.0 * obs.work["step"].bound_s() * 1e3 / obs.device_ms_per_step
