"""Kernels: K1 (``csrc/stat_counts.cu``, the logits -> per-class counts kernel) against
its bytes bound. Every K1 launch that a call made counts its batch's logits and targets
read once and 3 int32 counts per class written once (the configuration's ``k1_bytes``);
the bound is those bytes over the card's HBM peak, the time K1's own device time from
the profiler. Bytes come from the inputs' shapes, so padded rows count as waste."""

KERNEL_NAME = "stat_counts_kernel"


def read(tr):
    ops = [(op, b) for op, b in tr.call_ops() if KERNEL_NAME in op.name]
    if not ops:
        return None
    k1_bytes = tr.cell.config_module.k1_bytes
    bound_s = sum(k1_bytes(b) for _, b in ops) / tr.hbm_bytes_per_s
    busy_s = sum(op.t1 - op.t0 for op, _ in ops) * 1e-6
    return 100.0 * bound_s / busy_s
