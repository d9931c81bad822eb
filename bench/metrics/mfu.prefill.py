"""The one-shot prefills' share of the bf16 peak: the FLOPs of the real
prompt tokens (not the padding to ``max_seq``) over the summed
``prefill_ms`` times 989 TFLOP/s, in %."""
from bench.common import flops, peaks


def read(run):
    steps = [r for r in run.window_steps if r.prefill_ms]
    ms = sum(x for r in steps for x in r.prefill_ms)
    if ms <= 0:
        return None
    work = sum(flops.prefill_flops(run.model, n)
               for r in steps for n in r.prefill_lens)
    return 100.0 * work / (ms / 1e3 * peaks.BF16_FLOPS_S)
