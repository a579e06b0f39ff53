"""Metric API layer: device-to-host syncs per ``update`` / ``forward`` call, as
``torch.cuda.set_sync_debug_mode("warn")`` reports them over the traced window (a
floor: the mode flags only the syncs PyTorch itself knows of)."""


def read(tr):
    res = tr.result
    if not res.syncs_counted or not res.calls:
        return None
    return res.syncs_in_calls / res.calls
