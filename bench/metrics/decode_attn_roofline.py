"""The paged decode attention's share of its roofline in the traced part of
the window: the least time the card could take for the context lengths the
traced decode steps really had (bytes over HBM rate, or FLOPs over the bf16
rate), over the time of ``decode_split_kernel`` and
``decode_combine_kernel`` in the trace, in %."""
from bench.common import peaks

KERNELS = ("decode_split_kernel", "decode_combine_kernel")


def read(run):
    steps = [r for r in run.traced_steps if r.context_lens]
    if not steps:
        return None
    us = run.trace.kernel_us(KERNELS)
    if us <= 0:
        return None
    m = run.model
    hd = m.get("head_dim") or m["d_model"] // m["num_heads"]
    rows = run.mix["max_batch"]
    pages = -(-run.mix["max_seq"] // run.cfg["engine"]["page_size"])
    bound = 0.0
    for r in steps:
        nbytes, flops = peaks.paged_decode_cost(
            r.context_lens, rows, m["num_heads"], m["num_kv_heads"], hd,
            pages)
        bound += m["num_layers"] * peaks.bound_s(nbytes, flops)[0]
    return 100.0 * bound / (us / 1e6)
