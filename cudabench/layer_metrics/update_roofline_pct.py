"""Device work of one update: each call's input bytes read once plus the states'
bytes written once (the configuration's ``input_bytes`` and ``state_bytes``) over the
card's HBM peak, against the device busy time (the union of the intervals) of the
operations those calls launched, over the traced window."""


def read(tr):
    ops = tr.call_ops()
    if not ops:
        return None
    cm, cfg = tr.cell.config_module, tr.cfg
    batches = [tr.batches[s.meta["batch"]] for s in tr.calls()]
    bound_s = sum(cm.input_bytes(b) + cm.state_bytes(cfg, b) for b in batches) / tr.hbm_bytes_per_s
    busy_s = tr.trace.union_us([op for op, _ in ops]) * 1e-6
    return 100.0 * bound_s / busy_s
