"""rm.dram_bytes_per_read: row-store bytes the engine charged
(``EngineStats.bytes_from_dram``, the paper's modelled DRAM bytes) a read
served, over the traced window."""


def read(run):
    c = run.get("counters")
    if not c or not c["reads"]:
        return None
    return c["bytes_from_dram"] / c["reads"]
