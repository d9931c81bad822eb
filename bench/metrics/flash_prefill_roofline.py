"""The flash prefill's share of its roofline in the traced part of the
window: the least time the card could take at the kernel's input shape
(the prompt padded to ``max_seq``, causal) for each layer of each traced
prefill, over the time of ``flash_fwd_kernel`` in the trace, in %."""
from bench.common import peaks


def read(run):
    n = sum(len(r.prefill_ms) for r in run.traced_steps)
    us = run.trace.kernel_us(("flash_fwd_kernel",)) if n else 0.0
    if us <= 0:
        return None
    m = run.model
    hd = m.get("head_dim") or m["d_model"] // m["num_heads"]
    nbytes, flops = peaks.flash_prefill_cost(
        run.mix["max_seq"], m["num_heads"], m["num_kv_heads"], hd)
    bound = n * m["num_layers"] * peaks.bound_s(nbytes, flops)[0]
    return 100.0 * bound / (us / 1e6)
