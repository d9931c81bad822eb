"""The decode steps' share of the bf16 peak: the FLOPs the window's decode
tokens need (active weights, attention over each row's real context, the
LM head) over the summed ``decode_ms`` times 989 TFLOP/s, in %."""
from bench.common import flops, peaks


def read(run):
    steps = [r for r in run.window_steps if r.decode_ms and r.context_lens]
    ms = sum(x for r in steps for x in r.decode_ms)
    if ms <= 0:
        return None
    work = sum(flops.decode_token_flops(run.model, c)
               for r in steps for c in r.context_lens)
    return 100.0 * work / (ms / 1e3 * peaks.BF16_FLOPS_S)
