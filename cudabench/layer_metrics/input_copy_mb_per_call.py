"""Update engine: the bytes the engine copied into its static inputs
(``engine_report()``'s ``input_copy_bytes``) gained over the traced window, per
``update`` / ``forward`` call, in MB (1e6 bytes)."""


def read(tr):
    copied = tr.engine.get("input_copy_bytes")
    if copied is None or not tr.result.calls:
        return None
    return copied / tr.result.calls / 1e6
